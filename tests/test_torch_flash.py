"""Flash tier of the port against the JAX package, byte for byte:
quantization, the Hamming(72,64) codec (single and double errors), RBER
injection and ``deploy``. Inputs are made with numpy from a seed and fed
to both packages."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY
from repro.core import ecc as jecc
from repro.core import tiering as jtier
from repro.core.quant import quantize_int8 as jquant
from repro.models import dense as jdense
from repro_torch import interop
from repro_torch.core import ecc as tecc
from repro_torch.core import tiering as ttier
from repro_torch.core.quant import quantize_int8 as tquant

torch.set_num_threads(2)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (136, 7), (8, 1)])
def test_quantize_int8_is_byte_identical(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    w = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * 0.3
                    ).astype(dtype)
    wn = np.asarray(w)
    q_j, s_j = jquant(w, axis=0)
    q_t, s_t = tquant(_t(wn), axis=0)
    np.testing.assert_array_equal(_np(q_t), np.asarray(q_j))
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))


def _raw_and_parity(rng, k, n):
    raw = rng.integers(0, 256, (k, n), dtype=np.uint8)
    # the JAX encode returns its byte values as uint32; the port keeps uint8
    return raw, np.asarray(jecc.encode(jnp.asarray(raw))).astype(np.uint8)


@pytest.mark.parametrize("k,n", [(8, 1), (136, 48), (512, 33)])
def test_encode_is_byte_identical(k, n):
    raw, par_j = _raw_and_parity(np.random.default_rng(k + n), k, n)
    np.testing.assert_array_equal(_np(tecc.encode(_t(raw))), par_j)


@pytest.mark.parametrize("case", ["rber", "single", "double", "parity_byte"])
def test_check_and_correct_is_byte_identical(case):
    rng = np.random.default_rng(7)
    k, n = 256, 40
    raw, parity = _raw_and_parity(rng, k, n)
    raw, parity = raw.copy(), parity.copy()
    g = k // 8
    cws = rng.choice(g * n, size=60, replace=False)
    if case == "rber":
        raw, _ = jecc.inject_bit_errors_np(raw, 2e-3, 11)
    for c in cws:
        gi, col = divmod(int(c), n)
        bits = rng.choice(72, size=2 if case == "double" else 1,
                          replace=False)
        if case == "rber":
            break
        for bit in bits:
            if case == "parity_byte" or bit >= 64:
                parity[gi, col] ^= np.uint8(1 << (bit % 8))
            else:
                raw[gi * 8 + bit // 8, col] ^= np.uint8(1 << (bit % 8))
    want = [np.asarray(x) for x in jecc.check_and_correct(
        jnp.asarray(raw), jnp.asarray(parity))]
    got = [_np(x) for x in tecc.check_and_correct(_t(raw), _t(parity))]
    for w, gt, name in zip(want, got, ("corrected", "dirty", "uncorr")):
        np.testing.assert_array_equal(gt, w, err_msg=name)
    if case == "double":
        assert want[2].sum() == len(cws)     # every double error detected
    if case == "single":
        assert want[2].sum() == 0


def test_check_and_correct_works_in_chunks_of_k():
    """A (K, N) plane larger than one chunk is corrected chunk by chunk
    with the same answer as the JAX codec."""
    rng = np.random.default_rng(3)
    raw, parity = _raw_and_parity(rng, 1024, 8200)   # > 4M bytes: 2 chunks
    raw, _ = jecc.inject_bit_errors_np(raw, 1e-4, 5)
    want = np.asarray(jecc.check_and_correct(jnp.asarray(raw),
                                             jnp.asarray(parity))[0])
    got, _, _ = tecc.check_and_correct(_t(raw), _t(parity))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("rber", [1e-4, 2e-3, 0.05])
def test_inject_bit_errors_is_byte_identical(rber):
    raw = np.random.default_rng(1).integers(0, 256, (300, 17), dtype=np.uint8)
    want, n_want = jecc.inject_bit_errors_np(raw, rber, 42)
    got, n_got = tecc.inject_bit_errors_np(raw, rber, 42)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want
    inplace = _t(raw)
    assert tecc.inject_bit_errors_(inplace, rber, 42) == n_want
    np.testing.assert_array_equal(_np(inplace), want)


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(OPT_TINY, jax.random.PRNGKey(0))


@pytest.mark.parametrize("rber", [0.0, 1e-4, 2e-3])
def test_deploy_is_byte_identical(jax_params, rber):
    j_tiered, j_map = jtier.deploy(jax_params, rber=rber, seed=3)
    t_tiered, t_map = ttier.deploy(
        interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                  device="cpu"),
        rber=rber, seed=3)
    assert t_map == j_map
    want = interop.deployed_from_numpy(jax.tree.map(np.asarray, j_tiered),
                                       device="cpu")
    flat_w, flat_g = dict(ttier._walk(want)), dict(ttier._walk(t_tiered))
    assert flat_w.keys() == flat_g.keys()
    n_flash = 0
    for path, w in flat_w.items():
        g = flat_g[path]
        if isinstance(w, ttier.FlashWeight):
            n_flash += 1
            assert g.q.dtype == torch.int8 and g.parity.dtype == torch.uint8
            for field in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, field), getattr(w, field)), \
                    (path, field)
        else:
            assert g.dtype == torch.bfloat16 and torch.equal(g, w), path
    assert n_flash == 3                       # w_up, w_down, lm_head
    assert ttier.flash_bytes(t_tiered) == jtier.flash_bytes(j_tiered)


@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_attn_flash_copy_is_byte_identical(jax_params, rber):
    """The engine's per-layer Q/O flash copies (seed + layer)."""
    attn = jax_params["layers"]["attn"]
    for li in range(OPT_TINY.n_layers):
        for key in ("wq", "wo"):
            want = jtier.encode_flash(attn[key][li], rber=rber, seed=5 + li)
            got = ttier.encode_flash(_t(np.asarray(attn[key][li])),
                                     rber=rber, seed=5 + li)
            for field in ("q", "parity", "scale"):
                np.testing.assert_array_equal(
                    _np(getattr(got, field)), np.asarray(getattr(want, field)))
