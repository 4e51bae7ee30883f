"""Card-only checks: the port's CUDA kernels against their plain versions.

Needs an NVIDIA card and imports no JAX (the card's machine has none), so
run it without the JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Every test skips where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import ctypes
import math
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import ecc
from repro_torch.core.quant import quantize_int8
from repro_torch.kernels import build, ecdp
from repro_torch.kernels import paged_attn as pa

pytestmark = pytest.mark.gpu

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flash(rng, k, n, rber, seed):
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    q, scale = quantize_int8(w, axis=0)
    parity = ecc.encode(ecc.weights_to_bytes(q))
    raw = ecc.weights_to_bytes(q).clone()
    ecc.inject_bit_errors_(raw, rber, seed)
    return ecc.bytes_to_weights(raw), parity, scale


# the tests/test_kernels.py sweep, plus the serving shapes' traits: ragged
# N (not a multiple of 128), M past one 64-row launch, long K (split-K)
SHAPES = [(1, 64, 16), (4, 128, 64), (8, 512, 256), (3, 136, 48),
          (16, 256, 512), (64, 4096, 333), (100, 1024, 200), (4, 16384, 130)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("rber", [0.0, 1e-4, 2e-3])
@pytest.mark.parametrize("ecc_on", [True, False])
@pytest.mark.parametrize("adtype", [torch.bfloat16, torch.float32])
def test_ecdp_kernel_matches_plain(cuda, m, k, n, rber, ecc_on, adtype):
    rng = np.random.default_rng(m * k + n)
    wq, parity, scale = _flash(rng, k, n, rber, seed=k + n)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         ).to(adtype)
    want = ecdp.ecdp_matmul_plain(a, wq, parity, scale, ecc_on)
    before = ecdp.ecdp_matmul.launches
    got = ecdp.ecdp_matmul(a.to(cuda), wq.to(cuda), parity.to(cuda),
                           scale.to(cuda), ecc_enabled=ecc_on)
    torch.cuda.synchronize()
    assert ecdp.ecdp_matmul.launches == before + 1
    # Same integer weights, f32 sums in another order: the error of a
    # K-term f32 sum stays below ~sqrt(K) eps of the sum of |terms|
    # (taken 4x), plus the JAX sweep's own atol.
    mag = (a.float().abs() @ wq.float().abs()) * scale
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    err = (got.cpu() - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def test_ecdp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    wq, parity, scale = (t.to(cuda) for t in _flash(rng, 64, 32, 0.0, 0))
    a = torch.ones((4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        ecdp.ecdp_matmul(a.half(), wq, parity, scale)
    with pytest.raises(ValueError):
        ecdp.ecdp_matmul(a.t().contiguous().t(), wq, parity, scale)
    with pytest.raises(ValueError):
        ecdp.ecdp_matmul(a[:, :60].contiguous(), wq[:60], parity, scale)
    with pytest.raises(ValueError):
        ecdp.ecdp_matmul(a.cpu(), wq, parity, scale)


def _paged_inputs(rng, b, n_kv, tr, dh, bs, ctx, max_blocks):
    """bf16 pool with garbage fill and a scrambled block assignment."""
    n_blocks = 1 + b * max_blocks
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, max_blocks), np.int32)
    pi = 0
    for i in range(b):
        for j in range(-(-ctx[i] // bs)):
            tables[i, j] = perm[pi]
            pi += 1

    def bf(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)
    q = bf((b, n_kv, tr, dh))
    return (q, bf((n_blocks, bs, n_kv, dh)), bf((n_blocks, bs, n_kv, dh)),
            torch.from_numpy(tables), torch.tensor(ctx, dtype=torch.int32))


@pytest.mark.parametrize("b,n_kv,tr,dh,bs,ctx,max_blocks", [
    (4, 32, 16, 128, 16, [0, 2047, 300, 17], 128),   # the serving shapes
    (3, 2, 10, 32, 8, [5, 0, 32], 4),
    (2, 1, 56, 16, 4, [13, 28], 7),
    (1, 4, 1, 64, 16, [1], 1),
])
def test_paged_attn_kernel_matches_plain(cuda, b, n_kv, tr, dh, bs, ctx,
                                         max_blocks):
    rng = np.random.default_rng(b * tr + dh)
    q, kp, vp, tbl, lens = _paged_inputs(rng, b, n_kv, tr, dh, bs, ctx,
                                         max_blocks)
    args = [t.to(cuda) for t in (q * dh ** -0.5, kp, vp, tbl, lens)]
    before = pa.paged_attn.launches
    acc, m, l = pa.paged_attn(*args)
    torch.cuda.synchronize()
    assert pa.paged_attn.launches == before + 1
    # the bounds are stated beside kernel_errors (kernels/paged_attn.py):
    # m and l to f32 rounding, acc within 4x the spread of the bf16
    # roundings of p against the plain version and to 2e-4 (Frobenius)
    # against the plain version in the kernel's order; empty rows exact
    errs = pa.kernel_errors(*args, acc, m, l)
    assert all(v <= 1 for k, v in errs.items() if k != "max_abs_err"), errs


# Faults planted in a copy of the kernel's source, built outside the tree:
# the checks above must catch each. (text in csrc/paged_attn.cu, its fault)
FAULTS = {
    "none": None,
    "drop_block": ("  for (int j = j0; j < j1; ++j) {\n",
                   "  for (int j = j0; j < j1; ++j) {\n"
                   "    if (j == j0 + 1) continue;\n"),
    "skip_alpha_once": (
        "acc_s[i] = acc_s[i] * alpha_s[t] + (s0 + s1);",
        "acc_s[i] = (j == j0 + 2 ? acc_s[i] : acc_s[i] * alpha_s[t])"
        " + (s0 + s1);"),
    "p_unrounded": ("pr[r] = __bfloat162float(__float2bfloat16(p));",
                    "pr[r] = p;"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_paged_attn_checks_catch_planted_faults(cuda, tmp_path, fault):
    src = (build.CSRC / "paged_attn.cu").read_text()
    if FAULTS[fault] is not None:
        old, new = FAULTS[fault]
        assert src.count(old) == 1, f"{fault}: the text to alter has moved"
        src = src.replace(old, new)
    (tmp_path / "paged_attn.cu").write_text(src)
    lib_path = tmp_path / "paged_attn.so"
    subprocess.run(build.nvcc_command(tmp_path / "paged_attn.cu", lib_path),
                   check=True, capture_output=True)
    lib = pa._bind(ctypes.CDLL(str(lib_path)))
    # the serving shapes of chip_smoke.py's phase 3
    rng = np.random.default_rng(11)
    q, kp, vp, tbl, lens = (t.to(cuda) for t in _paged_inputs(
        rng, 4, 32, 16, 128, 16, [0, 2047, 513, 1200], 128))
    q = q * 128 ** -0.5
    acc, m, l = pa._launch(lib, q, kp, vp, tbl, lens)
    errs = pa.kernel_errors(q, kp, vp, tbl, lens, acc, m, l)
    print(f"\n{fault}: {errs}")
    worst = max(v for k, v in errs.items() if k != "max_abs_err")
    assert (worst <= 1) == (fault == "none"), errs
