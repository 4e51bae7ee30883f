"""The ECDP's plain version (the CPU path of ``kernels/ecdp.ecdp_matmul``)
against the JAX package: the Pallas kernel in interpret mode
(``ops.ecdp_matmul``), ``ref.ecdp_reference`` and ``ops.ecdp_matmul_xla``,
over the tests/test_kernels.py sweep at that file's tolerances. Inputs are
made with numpy from a seed and fed to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecc as jecc
from repro.core import erdpe as jerdpe
from repro.core import tiering as jtier
from repro.core.quant import quantize_int8 as jquant
from repro.kernels import ops, ref
from repro_torch import interop
from repro_torch.core import erdpe as terdpe
from repro_torch.kernels import ecdp as tecdp

torch.set_num_threads(2)


def _make(seed, m, k, n, rber, adtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), dtype=np.float32)
    q, scale = jquant(jnp.asarray(w), axis=0)
    raw = np.asarray(jecc.weights_to_bytes(q))
    # the JAX encode returns its byte values as uint32; feed both uint8
    parity = np.asarray(jecc.encode(jnp.asarray(raw))).astype(np.uint8)
    if rber:
        raw, _ = jecc.inject_bit_errors_np(raw, rber, seed)
    a = np.asarray(jnp.asarray(rng.standard_normal((m, k), dtype=np.float32)
                               ).astype(adtype))
    return a, raw.view(np.int8), parity, np.asarray(scale)


def _port(a, wq, parity, scale, **kw):
    def t(x):
        return interop.tensor_from_numpy(x, device="cpu")
    return tecdp.ecdp_matmul(t(a), t(wq), t(parity), t(scale), **kw).numpy()


SHAPES = [(1, 64, 16), (4, 128, 64), (8, 512, 256), (3, 136, 48),
          (16, 256, 512)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("rber", [0.0, 1e-4, 2e-3])
def test_plain_matches_pallas_and_oracle(m, k, n, rber):
    a, wq, parity, scale = _make(m * k + n, m, k, n, rber)
    got = _port(a, wq, parity, scale)
    pallas = ops.ecdp_matmul(a, wq, parity, scale)          # interpret on CPU
    oracle = ref.ecdp_reference(a, wq, parity, scale)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("adtype", [jnp.bfloat16, jnp.float32])
def test_plain_dtypes(adtype):
    a, wq, parity, scale = _make(5, 4, 256, 128, 1e-3, adtype)
    got = _port(a, wq, parity, scale)
    want = ops.ecdp_matmul(a, wq, parity, scale)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-1)
    want32 = ref.ecdp_reference(np.asarray(a, np.float32), wq, parity, scale)
    np.testing.assert_allclose(got, np.asarray(want32), rtol=2e-2, atol=2e-1)


def test_plain_ecc_off_uses_raw_weights():
    a, wq, parity, scale = _make(11, 2, 128, 32, 5e-3)
    off = _port(a, wq, parity, scale, ecc_enabled=False)
    want = ops.ecdp_matmul(a, wq, parity, scale, ecc_enabled=False)
    np.testing.assert_allclose(off, np.asarray(want), rtol=1e-5, atol=1e-4)
    xla = ops.ecdp_matmul_xla(a, wq, parity, scale, ecc_enabled=False)
    np.testing.assert_allclose(off, np.asarray(xla), rtol=1e-5, atol=1e-4)
    on = _port(a, wq, parity, scale, ecc_enabled=True)
    assert not np.allclose(off, on)


def test_plain_works_over_k_in_chunks():
    """K past one plain-version chunk (1024 rows) keeps the answer."""
    a, wq, parity, scale = _make(13, 3, 2056, 24, 2e-3)
    got = _port(a, wq, parity, scale)
    want = ops.ecdp_matmul_xla(a, wq, parity, scale, ecc_enabled=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)


def test_flash_matmul_shapes_and_dtype():
    """flash_matmul flattens leading dims, restores them, and matches the
    reference's (XLA-mode) flash_matmul."""
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((64, 48), dtype=np.float32))
    fw = jtier.encode_flash(w, rber=1e-4, seed=3)
    x = jnp.asarray(rng.standard_normal((2, 5, 64), dtype=np.float32)
                    ).astype(jnp.bfloat16)
    tfw = interop.flash_from_numpy(fw, device="cpu")
    tx = interop.tensor_from_numpy(np.asarray(x), device="cpu")
    out = terdpe.flash_matmul(tx, tfw)
    assert tuple(out.shape) == (2, 5, 48) and out.dtype == torch.bfloat16
    got = terdpe.flash_matmul(tx, tfw, out_dtype=torch.float32).numpy()
    want = jerdpe.flash_matmul(x, fw, out_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    a, wq, parity, scale = _make(1, 2, 64, 8, 0.0)
    before = tecdp.ecdp_matmul.launches
    out = _port(a, wq, parity, scale)
    assert tecdp.ecdp_matmul.launches == before
    np.testing.assert_allclose(
        out, tecdp.ecdp_matmul_plain(*(
            interop.tensor_from_numpy(x, device="cpu")
            for x in (a, wq, parity, scale))).numpy())
