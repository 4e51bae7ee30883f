"""Card-only checks: the port's CUDA kernels against their plain versions,
the weight page pool's stream ordering, the streamed engine against the
resident one, and the offline decode path through the decode kernel.

Needs an NVIDIA card and imports no JAX (the card's machine has none), so
run it without the JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Every test skips where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import subprocess
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import ecc
from repro_torch.core.quant import quantize_int8
from repro_torch.core.tiering import FlashWeight, PagedWeight
from repro_torch.kernels import build, ecdp
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels import paged_ecdp as pe
from repro_torch.store import PageStore, WeightPagePool

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
# N (not a multiple of 128), M past one 64-row tile, long K (split-K), and
# prefill's M = 512; then the tensor-core body's edges: M at and around its
# 16- and 64-row tiles (1, 15, 16, 17, 65), K with an 8-row tail inside a
# 16-deep MMA step (K % 16 == 8), and N % 16 != 0 (the narrow-load
# instantiation) beside N % 16 == 0 (16-byte loads)
SHAPES = [(1, 64, 16), (4, 128, 64), (8, 512, 256), (3, 136, 48),
          (16, 256, 512), (64, 4096, 333), (100, 1024, 200), (4, 16384, 130),
          (512, 2048, 300),
          (1, 72, 40), (15, 200, 100), (16, 264, 128), (17, 1032, 136),
          (65, 520, 264), (65, 2056, 384)]


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


# the other families' flash shapes the serving shapes above leave out:
# K 8960 and 12288 (split-K plans of rwkv6-3b's and recurrentgemma-9b's
# w_down) and seamless-m4t-medium's lm_head, N 256206 (not a multiple of
# 16: the narrow loads), at a decode step's M 4 and the prefill's M 512
FAMILY_SHAPES = [(4, 8960, 2560), (512, 8960, 2560), (4, 12288, 4096),
                 (512, 12288, 4096), (4, 1024, 256206), (512, 1024, 256206)]


@pytest.mark.parametrize("m,k,n", FAMILY_SHAPES)
@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_ecdp_at_the_family_shapes_matches_plain(cuda, m, k, n, rber):
    """The ECDP sweep's bound at the families' shapes, ECC on and off."""
    rng = np.random.default_rng(m + k + n)
    wq, parity, scale = (t.to(cuda) for t in _flash(rng, k, n, rber,
                                                    seed=k + n))
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         ).to(cuda, torch.bfloat16)
    mag = (a.float().abs() @ wq.float().abs()) * scale
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    for ecc_on in (True, False):
        want = ecdp.ecdp_matmul_plain(a, wq, parity, scale, ecc_on)
        got = ecdp.ecdp_matmul(a, wq, parity, scale, ecc_enabled=ecc_on)
        err = (got - want).abs()
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


@pytest.mark.parametrize("m", [4, 64, 100])
def test_ecdp_unaligned_activations_match_aligned(cuda, m):
    """Activations 2 bytes past a 16-byte boundary take the byte-load
    instantiation: the same launch plan and arithmetic as the 16-byte
    loads, so the same bits, within the ECDP bound of the plain version."""
    rng = np.random.default_rng(21 + m)
    k, n = 1032, 256
    wq, parity, scale = (t.to(cuda) for t in _flash(rng, k, n, 2e-3, 21))
    flat = torch.from_numpy(rng.standard_normal(m * k + 1, dtype=np.float32)
                            ).to(torch.bfloat16).to(cuda)
    odd = flat[1:].view(m, k)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    got = ecdp.ecdp_matmul(odd, wq, parity, scale)
    assert torch.equal(got, ecdp.ecdp_matmul(odd.clone(), wq, parity, scale))
    want = ecdp.ecdp_matmul_plain(odd, wq, parity, scale)
    mag = (odd.float().abs() @ wq.float().abs()) * scale
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    assert bool(((got - want).abs() <= bound).all())


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
    # the tensor-core body's edges: a 32-key block (two k16 tiles under one
    # max), a 40-key block (walked twice: K for the max, then K and V),
    # TR = 17 (a ragged second m tile), the OPT_TINY width (Dh 32, KV 4)
    (3, 4, 16, 128, 32, [70, 0, 513], 17),
    (2, 3, 16, 64, 40, [41, 359], 9),
    (2, 4, 17, 64, 16, [100, 7], 8),
    (3, 4, 16, 32, 16, [0, 40, 161], 11),
    # contexts ending mid-block, for each block-size class: one k16 tile
    # (4, 8, 16 keys), two (32), two walks (40): inside the first block,
    # inside the second, one short of a block's end past two ranges, one
    # past a range
    *[(4, 2, 16, 64, bs, [3, bs + 5, 17 * bs - 1, 8 * bs + 1], 20)
      for bs in (4, 8, 16, 32, 40)],
    # Dh 80 (OPT-2.7B: ten 16-byte pieces a row, five k16 steps): its
    # serving shape, and each block-size class (one k16 tile, two, two
    # walks) with contexts ending mid-block
    (4, 32, 16, 80, 16, [0, 2047, 300, 17], 128),
    *[(4, 2, 16, 80, bs, [3, bs + 5, 17 * bs - 1, 8 * bs + 1], 20)
      for bs in (8, 32, 40)],
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


def test_paged_attn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(3)
    q, kp, vp, tbl, lens = (t.to(cuda) for t in _paged_inputs(
        rng, 2, 2, 16, 64, 16, [20, 5], 2))
    pa.paged_attn(q, kp, vp, tbl, lens)
    with pytest.raises(TypeError):
        pa.paged_attn(q, kp.half(), vp.half(), tbl, lens)
    # a head size the kernel is not instantiated for
    q24, kp24, vp24, _, _ = (t.to(cuda) for t in _paged_inputs(
        rng, 2, 2, 16, 24, 16, [20, 5], 2))
    with pytest.raises(ValueError, match="Dh"):
        pa.paged_attn(q24, kp24, vp24, tbl, lens)
    # a contiguous pool view 2 bytes past a 16-byte boundary
    flat = torch.zeros(kp.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(kp.shape)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attn(q, odd, vp, tbl, lens)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attn(q, kp, odd, tbl, lens)


# Faults planted in a copy of the kernel's source, built outside the tree:
# the checks above must catch each. (texts in csrc/paged_attn.cu and what
# replaces each: its fault)
FAULTS = {
    "none": (),
    # the second pool block of every range: neither its max nor its PV
    "drop_block": (("    cp_commit();\n\n    const __nv_bfloat16* k_s =",
                    "    cp_commit();\n    if (u / upb == 1) continue;\n\n"
                    "    const __nv_bfloat16* k_s ="),),
    # acc not rescaled when the third block of a range raises the max
    "skip_alpha_once": (
        ("          for (int nd = 0; nd < ND; ++nd) {\n"
         "            acc[nd][0] *= alpha[0];",
         "          for (int nd = 0; nd < (jl == 2 ? 0 : ND); ++nd) {\n"
         "            acc[nd][0] *= alpha[0];"),),
    # p not rounded to bf16 for PV: its bf16 residual goes through a second
    # product (p = hi + lo to 16 bits)
    "p_unrounded": (
        ("      unsigned pa[NT][4];\n",
         "      unsigned pa[NT][4], pl[NT][4];\n"),
        ("          pa[nt][2 * hf + 1] = pack_bf16(p[2], p[3]);\n",
         "          pa[nt][2 * hf + 1] = pack_bf16(p[2], p[3]);\n"
         "          pl[nt][2 * hf] = pack_bf16(\n"
         "              p[0] - __bfloat162float(__float2bfloat16(p[0])),\n"
         "              p[1] - __bfloat162float(__float2bfloat16(p[1])));\n"
         "          pl[nt][2 * hf + 1] = pack_bf16(\n"
         "              p[2] - __bfloat162float(__float2bfloat16(p[2])),\n"
         "              p[3] - __bfloat162float(__float2bfloat16(p[3])));\n"),
        ("          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);\n",
         "          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);\n"
         "          mma_bf16(acc[2 * dp], pl[nt], vb[0], vb[1]);\n"
         "          mma_bf16(acc[2 * dp + 1], pl[nt], vb[2], vb[3]);\n")),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_paged_attn_checks_catch_planted_faults(cuda, tmp_path, fault):
    src = (build.CSRC / "paged_attn.cu").read_text()
    for old, new in FAULTS[fault]:
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


# Faults planted in a copy of the ECDP's source (ecdp_core.cuh + ecdp.cu),
# built outside the tree: the ECDP bound must catch each. (text in
# csrc/ecdp_core.cuh, its fault)
ECDP_FAULTS = {
    "none": None,
    "skip_correction": ("    if (ecc) {\n      correct_stage(s, kt, syn2bit);",
                        "    if (0) {\n      correct_stage(s, kt, syn2bit);"),
    "drop_last_step": ("      if (kb >= kt) break;",
                       "      if (kb >= (t == n_steps - 1 ? 0 : kt)) break;"),
    "swap_b_rows": (
        "const unsigned q0 = *reinterpret_cast<const unsigned*>(wb) ^ bias;\n"
        "      const unsigned q1 = *reinterpret_cast<const unsigned*>(wb + WS)"
        " ^ bias;",
        "const unsigned q0 = *reinterpret_cast<const unsigned*>(wb + WS) ^ "
        "bias;\n      const unsigned q1 = *reinterpret_cast<const unsigned*>"
        "(wb) ^ bias;"),
}


@pytest.mark.parametrize("fault", list(ECDP_FAULTS))
def test_ecdp_checks_catch_planted_faults(cuda, tmp_path, fault):
    src = (build.CSRC / "ecdp_core.cuh").read_text()
    if ECDP_FAULTS[fault] is not None:
        old, new = ECDP_FAULTS[fault]
        assert src.count(old) == 1, f"{fault}: the text to alter has moved"
        src = src.replace(old, new)
    (tmp_path / "ecdp_core.cuh").write_text(src)
    (tmp_path / "ecdp.cu").write_text((build.CSRC / "ecdp.cu").read_text())
    lib_path = tmp_path / "ecdp.so"
    subprocess.run(build.nvcc_command(tmp_path / "ecdp.cu", lib_path),
                   check=True, capture_output=True)
    lib = ecdp._bind(ctypes.CDLL(str(lib_path)))
    # the serving step's wq / wo shape (M = slots x chunk = 64), bf16
    # activations, RBER 2e-3 with ECC on
    rng = np.random.default_rng(13)
    k, n = 4096, 4096
    wq, parity, scale = (t.to(cuda) for t in _flash(rng, k, n, 2e-3, 13))
    a = torch.from_numpy(rng.standard_normal((64, k), dtype=np.float32)
                         ).to(torch.bfloat16).to(cuda)
    got = ecdp._launch(lib, a, wq, parity, scale, True)
    want = ecdp.ecdp_matmul_plain(a, wq, parity, scale, True)
    mag = (a.float().abs() @ wq.float().abs()) * scale
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    worst = float(((got - want).abs() / bound).max())
    print(f"\n{fault}: error / bound {worst:.3e}")
    assert (worst <= 1) == (fault == "none"), worst


# --- paged ECDP ------------------------------------------------------------

def _paged_pool(cuda, weights, spare=0, seed=0):
    """Program ``{name: (wq, parity, scale)}`` into a store and upload all
    of it into a pool on the card whose free list is shuffled (scrambled
    page tables). Returns (pool, {name: table})."""
    store = PageStore(n_planes=8)
    for name, (wq, parity, scale) in weights.items():
        store.put(name, FlashWeight(wq, parity, scale))
    n_pages = sum(store.entry_pages(n) for n in weights) + spare
    pool = WeightPagePool(store, n_pages, device=cuda)
    pool._free = [int(s) for s in
                  np.random.default_rng(seed).permutation(n_pages)]
    tbls = pool.upload(list(weights))
    torch.cuda.synchronize()
    return pool, tbls


# then the tensor-core body's edges, as for the ECDP above
PAGED_SHAPES = [(1, 128, 128), (4, 256, 128), (3, 200, 72), (8, 64, 384),
                (5, 640, 256), (64, 136, 384), (64, 4096, 1000),
                (100, 2048, 200),
                (1, 72, 96), (15, 264, 256), (16, 128, 384), (17, 520, 200),
                (65, 1032, 128)]


@pytest.mark.parametrize("m,k,n", PAGED_SHAPES)
@pytest.mark.parametrize("rber", [0.0, 1e-4, 2e-3])
@pytest.mark.parametrize("adtype", [torch.bfloat16, torch.float32])
def test_paged_ecdp_kernel_matches_plain_and_ecdp(cuda, m, k, n, rber,
                                                  adtype):
    rng = np.random.default_rng(m * k + n + 1)
    wq, parity, scale = _flash(rng, k, n, rber, seed=k + n)
    pool, tbls = _paged_pool(cuda, {"w": (wq, parity, scale)}, spare=7,
                             seed=m + k)
    pw = PagedWeight(pool.buffer, *tbls["w"]["dev"], kn=(k, n))
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         ).to(adtype).to(cuda)
    dense = [t.to(cuda) for t in (wq, parity, scale)]
    for ecc_on in (True, False):
        before = pe.paged_ecdp_matmul.launches
        got = pe.paged_ecdp_matmul(a, pw.pool, pw.q_tbl, pw.p_slots,
                                   pw.s_slots, pw.kn, ecc_enabled=ecc_on)
        torch.cuda.synchronize()
        assert pe.paged_ecdp_matmul.launches == before + 1
        # the same kernel body and K split as the ECDP on the dense weight
        assert torch.equal(got, ecdp.ecdp_matmul(a, *dense,
                                                 ecc_enabled=ecc_on))
        want = pe.paged_ecdp_matmul_plain(a, pw.pool, pw.q_tbl, pw.p_slots,
                                          pw.s_slots, pw.kn, ecc_on)
        mag = (a.float().abs() @ dense[0].float().abs()) * dense[2]
        bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
        err = (got - want).abs()
        assert bool((err <= bound).all()), float((err - bound).max())


def test_paged_ecdp_wrapper_rejects_cpu_tables(cuda):
    rng = np.random.default_rng(0)
    pool, tbls = _paged_pool(cuda, {"w": _flash(rng, 128, 128, 0.0, 0)})
    q_tbl, p_slots, s_slots = tbls["w"]["dev"]
    a = torch.ones((4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        pe.paged_ecdp_matmul(a, pool.buffer, q_tbl.cpu(), p_slots, s_slots,
                             (128, 128))


class _Forgetful(dict):
    """A slot -> free-event map that keeps nothing: an upload then waits
    for no earlier reader (the fault the pool's events exist to stop)."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.parametrize("waits", [True, False], ids=["events", "no_events"])
def test_slot_reuse_waits_for_earlier_readers(cuda, monkeypatch, waits):
    """Write after read across streams: hold the consumer stream, launch a
    paged matmul on a window, free the window's slots and upload other
    pages into them from another thread. With the pool's free events the
    earlier launch still returns the old weight's product; with them
    dropped the upload overtakes it and the product is wrong — so this
    test can see the hazard."""
    rng = np.random.default_rng(5)
    k, n = 1024, 512
    old, new = _flash(rng, k, n, 0.0, 1), _flash(rng, k, n, 0.0, 2)
    store = PageStore(n_planes=8)
    store.put("old", FlashWeight(*old))
    store.put("new", FlashWeight(*new))
    pool = WeightPagePool(store, store.entry_pages("old"), device=cuda)
    if not waits:
        monkeypatch.setattr(pool, "_freed_at", _Forgetful())
    t_old = pool.upload(["old"])["old"]
    a = torch.from_numpy(rng.standard_normal((16, k), dtype=np.float32)
                         ).to(torch.bfloat16).to(cuda)
    want = ecdp.ecdp_matmul(a, *(x.to(cuda) for x in old))
    torch.cuda.synchronize()
    pool.stream.wait_event(t_old["ready"])
    torch.cuda._sleep(2_000_000_000)          # about a second at 1.98 GHz
    got = pe.paged_ecdp_matmul(a, pool.buffer, *t_old["dev"], (k, n))
    pool.free(t_old["slots"])
    res = {}
    th = threading.Thread(target=lambda: res.update(pool.upload(["new"])))
    th.start()
    th.join()
    assert sorted(res["new"]["slots"]) == sorted(t_old["slots"])
    assert not pool.stream.query(), "the hold ended before the upload"
    if not waits:             # the write landed while the read still waited
        res["new"]["ready"].synchronize()
        assert not pool.stream.query(), "the hold ended before the write"
    torch.cuda.synchronize()
    print(f"\n{'events' if waits else 'no events'}: max |got - old "
          f"product| {float((got - want).abs().max()):.3e}")
    assert torch.equal(got, want) == waits


def test_page_tables_never_take_a_block_the_consumer_still_reads(cuda):
    """An upload from another thread while the consumer stream still has a
    queued kernel reading a block it has freed: the page-table tensor,
    written on the copy stream at once, must not be handed that block."""
    rng = np.random.default_rng(9)
    store = PageStore(n_planes=8)
    store.put("w", FlashWeight(*_flash(rng, 1024, 512, 0.0, 3)))
    n = store.entry_pages("w")
    pool = WeightPagePool(store, n, device=cuda)
    pool.free(pool.upload(["w"])["w"]["slots"])   # staging buffer made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # few free blocks left for x to join
    x = torch.full((n,), 7, dtype=torch.int32, device=cuda)
    torch.cuda._sleep(2_000_000_000)
    total = x.sum()                 # queued behind the hold
    del x                           # its block is free for the stream's reuse
    th = threading.Thread(target=pool.upload, args=(["w"],))
    th.start()
    th.join()
    assert not pool.stream.query(), "the hold ended before the upload"
    assert int(total) == 7 * n


def test_streamed_engine_logits_equal_resident_on_the_card(cuda):
    """OPT_TINY streamed under a budget (worker thread, copy stream, pool
    slot reuse) against the resident engine on the card: logits equal bit
    for bit at every step."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import StreamConfig

    from repro_torch.core.scheduler import AdmissionConfig

    params = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    # a budget whose stall contraction never binds (at worst 512/16 = 32 =
    # 2 slots x 16 lanes): both engines plan the same steps
    kw = dict(max_slots=2, max_seq=96, rber=1e-4, seed=1, device=cuda,
              admission_cfg=AdmissionConfig(token_budget=512))
    res = Engine(OPT_TINY, params, **kw)
    probe = PageStore()
    Engine(OPT_TINY, params, weight_store=probe, **kw)
    stm = Engine(OPT_TINY, params, weight_store=PageStore(),
                 stream_cfg=StreamConfig(
                     device_budget_bytes=int(probe.total_bytes * 0.6)), **kw)
    launches = pe.paged_ecdp_matmul.launches
    for e in (res, stm):
        e.submit(list(range(3, 60)), max_new=10)
        e.submit([7, 1, 5], max_new=10)
    steps = 0
    while res.step():
        stm.step()
        assert torch.equal(res.last_logits, stm.last_logits), steps
        steps += 1
    assert stm.step() == 0
    st = stm.stream_stats()
    assert st["bytes_streamed"] > 0 and st["pool_grows"] == 0
    assert st["pool_uploads"] == st["groups_streamed"]
    assert pe.paged_ecdp_matmul.launches - launches == \
        steps * OPT_TINY.n_layers * 4


def test_armed_streamed_engine_serves_the_disarmed_tokens(cuda):
    """OPT_TINY streamed under a budget that re-reads windows every step,
    from a store armed with transient flips and stuck pages: the card
    engine's tokens and logits equal the disarmed engine's at every step,
    with corrected, retried and relocated pages counted."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import StreamConfig
    from repro_torch.store.faults import FaultConfig, FaultInjector

    params = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(2),
                        device=cuda)
    kw = dict(max_slots=2, max_seq=96, rber=1e-4, seed=1, device=cuda,
              admission_cfg=AdmissionConfig(token_budget=512))
    probe = PageStore()
    Engine(OPT_TINY, params, weight_store=probe, **kw)
    scfg = StreamConfig(device_budget_bytes=int(probe.total_bytes * 0.6),
                        group_size=1, prefetch_depth=2)
    engines = []
    for armed in (False, True):
        store = PageStore(n_planes=8)
        eng = Engine(OPT_TINY, params, weight_store=store, stream_cfg=scfg,
                     **kw)
        if armed:
            store.attach_injector(FaultInjector(FaultConfig(
                seed=3, read_rber=2e-5, stuck_page_rate=0.2)))
        eng.submit(list(range(3, 60)), max_new=10)
        eng.submit([7, 1, 5], max_new=10)
        engines.append(eng)
    clean, armed = engines
    steps = 0
    while clean.step():
        armed.step()
        assert torch.equal(clean.last_logits, armed.last_logits), steps
        steps += 1
    assert armed.step() == 0
    assert [r.out for r in clean.requests.values()] == \
        [r.out for r in armed.requests.values()]
    s = armed.stream_stats()
    for k in ("ecc_corrected_pages", "uecc_detected", "read_retries",
              "relocations"):
        assert s[k] > 0, (k, s)
    assert armed.wpool.used_pages == sum(
        armed.store.entry_pages(n) for g in range(armed.n_groups)
        if g in armed.cache for n in armed._group_entries(g))


def test_batched_verify_matches_the_per_page_form_on_many_pages(cuda):
    """The store's batched host verify on a few thousand random pages with
    planted 1-, 2- and 3-bit codewords (on the card machine's host and
    threads) against the per-page ``check_and_correct_np``; and a single
    flip in every planted-1 codeword is repaired."""
    rng = np.random.default_rng(7)
    n, t = 3000, 128
    pages = rng.integers(0, 256, (n, t, t), dtype=np.uint8)
    # the error bytes against an all-zero parity plane are the encoding
    pars = ecc.page_errors(pages, np.zeros((n, t // 8, t), np.uint8))
    clean = pages.copy()
    single = []
    for i in range(n):                    # plant 1-, 2-, 3-bit codewords
        hit = []
        for nbits in (1, 2, 3):
            g, col = int(rng.integers(0, t // 8)), int(rng.integers(0, t))
            hit.append((g, col))
            for b in rng.choice(64, size=nbits, replace=False):
                pages[i, 8 * g + b // 8, col] ^= np.uint8(1 << (b % 8))
        if hit[0] not in hit[1:]:
            single.append((i,) + hit[0])
    c, d, u = ecc.check_and_correct_pages(pages, pars)
    inplace = pages.copy()
    dirty, uecc = ecc.correct_pages_(inplace, pars)
    np.testing.assert_array_equal(inplace, c)
    np.testing.assert_array_equal(dirty, d.any(axis=(1, 2)))
    np.testing.assert_array_equal(uecc, u.sum(axis=(1, 2)))
    for i in range(0, n, 97):
        want = ecc.check_and_correct_np(pages[i], pars[i])
        for got, w in zip((c[i], d[i], u[i]), want):
            np.testing.assert_array_equal(got, w)
    assert u.sum() >= n                   # every 2-bit codeword flagged
    for i, g, col in single:              # every lone 1-bit one repaired
        np.testing.assert_array_equal(c[i, 8 * g:8 * g + 8, col],
                                      clean[i, 8 * g:8 * g + 8, col])


# --- decode attention --------------------------------------------------------

# (B, S_max, KV, rep, Dh, lengths): chip_smoke.py phase 8(a)'s shapes (the
# OPT-6.7B decode shape, GQA, MQA with S_max a multiple of neither the tile
# nor the split), lengths 0 and S_max among them; and small odd ones
DECODE_SHAPES = [
    (4, 2048, 32, 1, 128, [0, 1, 513, 2048]),
    (3, 2048, 8, 4, 128, [0, 700, 2048]),
    (2, 1000, 1, 8, 128, [1000, 37]),
    (3, 40, 2, 3, 32, [40, 0, 33]),
    (1, 300, 4, 2, 256, [300]),
]


def _decode_inputs(rng, b, s_max, n_kv, rep, dh, dtype):
    """Unscaled queries (B, H, Dh) and caches (B, S_max, KV, Dh)."""
    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dtype)
    return (mk(b, n_kv * rep, dh), mk(b, s_max, n_kv, dh),
            mk(b, s_max, n_kv, dh))


def _check_decode_kernel(cuda, b, s_max, n_kv, rep, dh, lens, dtype):
    rng = np.random.default_rng(b * s_max + dh)
    q, kc, vc = (t.to(cuda) for t in _decode_inputs(rng, b, s_max, n_kv, rep,
                                                     dh, dtype))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    qg = da.group_decode_queries(q, n_kv, dtype)
    assert da.uses_mma(qg, kc, vc) == (dtype == torch.bfloat16
                                       and dh in (32, 64, 80, 128))
    before = da.decode_attention_state.launches
    acc, m, l = da.decode_attention_state(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert da.decode_attention_state.launches == before + 1
    # the bounds are stated beside kernel_errors (kernels/decode_attn.py):
    # m and l to f32 rounding, acc within 4x the spread of the roundings of
    # p against the plain version and to 2e-4 (Frobenius) against the plain
    # version in the kernel's order; empty slots exact
    errs = da.kernel_errors(qg, kc, vc, lens, acc, m, l)
    assert all(v <= 1 for k, v in errs.items() if k != "max_abs_err"), errs
    # the entry on grouped queries launches the same kernel: the same bits
    got = da.decode_attn(qg, kc, vc, lens)
    assert da.decode_attention_state.launches == before + 2
    assert all(torch.equal(g, w) for g, w in zip(got, (acc, m, l)))


@pytest.mark.parametrize("b,s_max,n_kv,rep,dh,lens", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attn_kernel_matches_plain(cuda, b, s_max, n_kv, rep, dh,
                                          lens, dtype):
    _check_decode_kernel(cuda, b, s_max, n_kv, rep, dh, lens, dtype)


# The walk's edges: lengths just before, on and just after a 32-row chunk
# and a 64-row range (1, 31, 32, 33, 63, 64, 65, S_max), in bf16 at every
# tensor-core head size, rep 1, 3, 4, 8 and 17 (two m tiles; KV=5 leaves
# a thread block of one head); then the CUDA-core body at the same
# lengths: an f32 cache, and Dh=256 in bf16. (B, S_max, KV, rep, Dh,
# lengths, dtype). The ordered check bounds the Frobenius norm of the whole
# state, so a case needs enough rows that one bf16 rounding of p which an
# f32 score difference tips the other way stays inside it: at KV=2 the
# rep-17 case's 102 rows let one such rounding (one ulp of a p near 0.7)
# reach 1.12 of the bound; at KV=8 it has 408.
EDGE_LENS = [1, 31, 32, 33, 63, 64, 65]
DECODE_EDGE_CASES = [
    (8, 130, 2, 1, 128, EDGE_LENS + [130], torch.bfloat16),
    (8, 200, 3, 3, 64, EDGE_LENS + [200], torch.bfloat16),
    (8, 129, 4, 4, 32, (EDGE_LENS + [129])[::-1], torch.bfloat16),
    (4, 257, 2, 8, 128, [65, 128, 129, 257], torch.bfloat16),
    (3, 100, 8, 17, 64, [1, 64, 100], torch.bfloat16),
    (2, 96, 5, 17, 32, [33, 96], torch.bfloat16),
    (8, 130, 2, 3, 64, EDGE_LENS + [130], torch.float32),
    (3, 200, 2, 2, 256, [1, 65, 200], torch.bfloat16),
    # Dh 80 (OPT-2.7B): the tensor-core body (bf16) and the CUDA-core body
    # with lanes idle past Dh in its partial 32-column step (f32), at the
    # OPT-2.7B decode shape and at the walk's edges with rep 3
    (4, 2048, 32, 1, 80, [0, 1, 513, 2048], torch.bfloat16),
    (4, 2048, 32, 1, 80, [0, 1, 513, 2048], torch.float32),
    (8, 130, 2, 3, 80, EDGE_LENS + [130], torch.bfloat16),
    (8, 130, 2, 3, 80, EDGE_LENS + [130], torch.float32),
    # the other families' shapes: recurrentgemma-9b's ring (MQA, 16 query
    # heads on one KV head, Dh 256: the CUDA-core body at rep 16) at its
    # edges, seamless-m4t-medium's self-KV (96 rows) and its cross-KV at
    # its full length
    (4, 2048, 1, 16, 256, [1, 700, 2047, 2048], torch.bfloat16),
    (4, 96, 16, 1, 64, [1, 33, 64, 96], torch.bfloat16),
    (4, 128, 16, 1, 64, [128] * 4, torch.bfloat16),
]


@pytest.mark.parametrize("b,s_max,n_kv,rep,dh,lens,dtype", DECODE_EDGE_CASES)
def test_decode_attn_kernel_edges_match_plain(cuda, b, s_max, n_kv, rep, dh,
                                              lens, dtype):
    _check_decode_kernel(cuda, b, s_max, n_kv, rep, dh, lens, dtype)


def test_decode_attn_unaligned_caches_take_the_cuda_core_body(cuda):
    """bf16 caches 2 bytes past a 16-byte boundary cannot take the
    tensor-core body's 16-byte copies: the CUDA-core body runs them, held
    to the same checks."""
    rng = np.random.default_rng(23)
    q, kc, vc = _decode_inputs(rng, 2, 96, 4, 2, 128, torch.bfloat16)
    lens = torch.tensor([70, 96], dtype=torch.int32, device=cuda)

    def odd(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
        flat[1:] = t.reshape(-1).to(cuda)
        return flat[1:].view(t.shape)
    kc, vc = odd(kc), odd(vc)
    assert kc.is_contiguous() and kc.data_ptr() % 16
    qg = da.group_decode_queries(q.to(cuda), 4, torch.bfloat16)
    assert not da.uses_mma(qg, kc, vc)
    acc, m, l = da.decode_attention_state(q.to(cuda), kc, vc, lens)
    errs = da.kernel_errors(qg, kc, vc, lens, acc, m, l)
    assert all(v <= 1 for k, v in errs.items() if k != "max_abs_err"), errs


def test_decode_attn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    q, kc, vc = (t.to(cuda) for t in _decode_inputs(rng, 2, 64, 2, 2, 64,
                                                     torch.bfloat16))
    lens = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    da.decode_attention_state(q, kc, vc, lens)
    with pytest.raises(TypeError):                       # fp16 cache
        da.decode_attention_state(q, kc.half(), vc.half(), lens)
    with pytest.raises(TypeError):                       # mixed dtypes
        da.decode_attention_state(q, kc, vc.float(), lens)
    with pytest.raises(TypeError):                       # int64 lengths
        da.decode_attention_state(q, kc, vc, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_state(q, kc.transpose(0, 1).contiguous()
                                  .transpose(0, 1), vc, lens)
    with pytest.raises(ValueError):                      # lengths on the CPU
        da.decode_attention_state(q, kc, vc, lens.cpu())
    with pytest.raises(ValueError):                      # Dh not a multiple
        q2, k2, v2 = (t.to(cuda) for t in _decode_inputs(    # of 16
            rng, 2, 64, 2, 2, 40, torch.bfloat16))
        da.decode_attention_state(q2, k2, v2, lens)


# Faults planted in a copy of the kernel's source, built outside the tree:
# the checks above must catch each. (the cache dtypes each runs, and the
# texts in csrc/decode_attn.cu and what replaces each: its fault)
BF16, F32 = torch.bfloat16, torch.float32
DECODE_FAULTS = {
    "none": ((BF16, F32), ()),
    # tensor-core body: the second 32-row chunk of every range, neither its
    # max nor its PV
    "drop_chunk": ((BF16,), (
        ("    cp_commit();\n\n    const __nv_bfloat16* t_s =",
         "    cp_commit();\n    if (u >> 1 == 1) continue;\n\n"
         "    const __nv_bfloat16* t_s ="),)),
    # acc not rescaled when a range's second chunk raises the max
    "skip_alpha_once": ((BF16,), (
        ("        for (int nd = 0; nd < ND; ++nd) {\n"
         "          acc[nd][0] *= alpha[0];",
         "        for (int nd = 0; nd < (c == 1 ? 0 : ND); ++nd) {\n"
         "          acc[nd][0] *= alpha[0];"),)),
    # p not rounded to bf16 for PV: its bf16 residual goes through a second
    # product (p = hi + lo to 16 bits)
    "p_unrounded": ((BF16,), (
        ("  unsigned pa[2][4];", "  unsigned pa[2][4], pl[2][4];"),
        ("          pa[nt][2 * hf + 1] = pack_bf16(p[2], p[3]);\n",
         "          pa[nt][2 * hf + 1] = pack_bf16(p[2], p[3]);\n"
         "          pl[nt][2 * hf] = pack_bf16(\n"
         "              p[0] - __bfloat162float(__float2bfloat16(p[0])),\n"
         "              p[1] - __bfloat162float(__float2bfloat16(p[1])));\n"
         "          pl[nt][2 * hf + 1] = pack_bf16(\n"
         "              p[2] - __bfloat162float(__float2bfloat16(p[2])),\n"
         "              p[3] - __bfloat162float(__float2bfloat16(p[3])));\n"),
        ("          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);\n",
         "          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);\n"
         "          mma_bf16(acc[2 * dp], pl[nt], vb[0], vb[1]);\n"
         "          mma_bf16(acc[2 * dp + 1], pl[nt], vb[2], vb[3]);\n"))),
    # CUDA-core body (the f32 cache): the second tile of every range
    "f32_drop_tile": ((F32,), (
        ("  for (int t0 = r0; t0 < r1; t0 += TILE) {\n",
         "  for (int t0 = r0; t0 < r1; t0 += TILE) {\n"
         "    if (t0 == r0 + TILE) continue;\n"),)),
}


@pytest.mark.parametrize("fault", list(DECODE_FAULTS))
def test_decode_attn_checks_catch_planted_faults(cuda, tmp_path, fault):
    dtypes, edits = DECODE_FAULTS[fault]
    src = (build.CSRC / "decode_attn.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"{fault}: the text to alter has moved"
        src = src.replace(old, new)
    (tmp_path / "decode_attn.cu").write_text(src)
    lib_path = tmp_path / "decode_attn.so"
    subprocess.run(build.nvcc_command(tmp_path / "decode_attn.cu", lib_path),
                   check=True, capture_output=True)
    lib = da._bind(ctypes.CDLL(str(lib_path)))
    # chip_smoke.py phase 8(a)'s OPT-6.7B decode shape
    for dtype in dtypes:
        rng = np.random.default_rng(12)
        q, kc, vc = (t.to(cuda) for t in _decode_inputs(
            rng, 4, 2048, 32, 1, 128, dtype))
        lens = torch.tensor([0, 1, 513, 2048], dtype=torch.int32,
                            device=cuda)
        qg = da.group_decode_queries(q, 32, dtype)
        acc, m, l = da._launch(lib, qg, kc, vc, lens)
        errs = da.kernel_errors(qg, kc, vc, lens, acc, m, l)
        print(f"\n{fault} {dtype}: {errs}")
        worst = max(v for k, v in errs.items() if k != "max_abs_err")
        assert (worst <= 1) == (fault == "none"), errs


def test_offline_decode_runs_the_kernels_and_matches_the_cpu(cuda):
    """OPT_TINY deployed at RBER 1e-4: prefill + greedy decode on the card
    through the decode and ECDP kernels (launches counted), logits within
    chip_smoke's 2^-6 of the row's largest logit of the same steps on the
    CPU fed the same tokens."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.core.tiering import deploy
    from repro_torch.models import dense

    raw = dense.init(OPT_TINY, torch.Generator().manual_seed(3), device="cpu")
    p_cpu, _ = deploy(raw, rber=1e-4, seed=1)
    p_gpu, _ = deploy(_to(raw, cuda), rber=1e-4, seed=1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, OPT_TINY.vocab_size, (3, 9))).int()
    lg_c, c_cpu = dense.prefill(OPT_TINY, p_cpu, {"tokens": toks}, pad_to=32)
    lg_g, c_gpu = dense.prefill(OPT_TINY, p_gpu, {"tokens": toks.to(cuda)},
                                pad_to=32)
    n_attn = da.decode_attention_state.launches
    n_ecdp = ecdp.ecdp_matmul.launches
    for i in range(6):
        tok = lg_c.argmax(-1).int()
        lg_c, c_cpu = dense.decode_step(OPT_TINY, p_cpu, c_cpu,
                                        {"token": tok, "kv_len": 9 + i})
        lg_g, c_gpu = dense.decode_step(OPT_TINY, p_gpu, c_gpu,
                                        {"token": tok.to(cuda),
                                         "kv_len": 9 + i})
        row_max = lg_c.abs().amax(-1, keepdim=True)
        assert bool(((lg_g.cpu() - lg_c).abs() <= 2.0 ** -6 * row_max).all())
    assert da.decode_attention_state.launches - n_attn == 6 * OPT_TINY.n_layers
    assert ecdp.ecdp_matmul.launches - n_ecdp == 6 * (2 * OPT_TINY.n_layers
                                                      + 1)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --- compiled steps (CUDA graphs) --------------------------------------------

# the kernel one wrapper call launches once (beside its merge or split-K
# reduce), by the start of its name; the paged ECDP shares the ECDP's
MAIN_KERNELS = {"ecdp": ("ecdp_mma_kernel<", "ecdp_kernel<"),
                "paged_attn": ("paged_attn_split_kernel<",),
                "decode_attn": ("decode_attn_mma_kernel<",
                                "decode_attn_split_kernel<")}


def _counts():
    """The wrappers' launch counts, by MAIN_KERNELS name."""
    return {"ecdp": ecdp.ecdp_matmul.launches + pe.paged_ecdp_matmul.launches,
            "paged_attn": pa.paged_attn.launches,
            "decode_attn": da.decode_attention_state.launches}


def _since(before):
    return {k: n - before[k] for k, n in _counts().items()}


def _profiled(fn):
    """fn() under torch.profiler: its result and the card's records of each
    MAIN_KERNELS kernel (a replay's kernels show here, one record each;
    its launches tick no counter)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    records = {name: 0 for name in MAIN_KERNELS}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, starts in MAIN_KERNELS.items():
            if any(k in evt.key for k in starts):
                records[name] += evt.count
    return out, records


def _serve(eng, scenario):
    """tests/test_engine_jit.py's slot-churn and mixed-workload scenarios
    (the mixed one with the port's margin-safe second prompt,
    tests/test_torch_engine.py::_mixed). Returns (tokens per request,
    per-step logits)."""
    logits = []

    def step():
        n = eng.step()
        if n:
            logits.append(eng.last_logits.clone())
        return n
    if scenario == "slot_churn":
        r1 = eng.submit([1, 2, 3], max_new=2)
        r2 = eng.submit([5, 6, 7, 8, 9], max_new=12)
        while not eng.requests[r1].done:
            step()
        r3 = eng.submit([2, 2], max_new=4)
        rids = [r1, r2, r3]
    else:
        prompts = [[7], list(range(2, 10)), list(range(1, 21)),
                   list(range(1, 30)), [3, 1, 4]]
        rids = [eng.submit(p, max_new=4 + i) for i, p in enumerate(prompts)]
    while step():
        pass
    return [eng.requests[r].out for r in rids], logits


@pytest.mark.parametrize("scenario", ["slot_churn", "mixed_workload"])
def test_compiled_engine_replays_one_graph_bit_equal_to_eager(cuda,
                                                              scenario):
    """OPT_TINY on the card: the compiled engine captures its step once
    (step_traces == 1 through slot churn, chunked prefills and
    oversubscribed admission, and a second wave) and every replay's tokens
    and logits equal the eager engine's bit for bit. Its counters tick at
    the warm-up and the capture only, each once a step's launches; a
    profile of the second wave holds, replay by replay, the kernels the
    eager engine launched and counted in that wave."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    params = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    adm = (AdmissionConfig(chunk_tokens=8, token_budget=16)
           if scenario == "mixed_workload" else None)
    runs = {}
    for compiled in (True, False):
        eng = Engine(OPT_TINY, params, max_slots=2, max_seq=96, rber=1e-4,
                     seed=1, device=cuda, admission_cfg=adm,
                     compiled=compiled)
        before = _counts()
        out, logits = _serve(eng, scenario)
        torch.cuda.synchronize()
        run = dict(out=out, logits=logits, launches=_since(before),
                   stats=list(eng.stats))
        before = _counts()
        _, run["records"] = _profiled(lambda: _serve(eng, "slot_churn"))
        run["wave2"] = _since(before)
        run["traces"] = eng.step_traces
        runs[compiled] = run
    comp, eager = runs[True], runs[False]
    assert comp["traces"] == 1 and eager["traces"] == -1
    assert comp["out"] == eager["out"]
    assert comp["stats"] == eager["stats"]
    bodies = len(eager["stats"])
    assert comp["launches"]["ecdp"] > 0 and comp["launches"]["paged_attn"] > 0
    assert eager["launches"] == {k: n // 2 * bodies
                                 for k, n in comp["launches"].items()}
    assert comp["wave2"] == {k: 0 for k in MAIN_KERNELS}
    assert comp["records"] == eager["records"] == eager["wave2"]
    assert len(comp["logits"]) == len(eager["logits"]) > 0
    for i, (got, want) in enumerate(zip(comp["logits"], eager["logits"])):
        assert torch.equal(got, want), (i, float((got - want).abs().max()))


def test_compiled_engine_samples_inside_the_graph(cuda):
    """A non-greedy compiled engine draws from its generator inside the
    graph: two engines with the same seed draw the same tokens, all in the
    vocabulary (or the build cannot register a generator, and the engine
    refuses)."""
    from repro_torch import graphs
    from repro_torch.configs import OPT_TINY
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig

    params = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    kw = dict(max_slots=2, max_seq=96, seed=7, device=cuda,
              sample_cfg=SampleConfig(temperature=0.8, top_k=50, top_p=0.9))
    if not graphs.can_capture_generator():
        with pytest.raises(ValueError, match="generator"):
            Engine(OPT_TINY, params, **kw)
        return
    outs = []
    for _ in range(2):
        eng = Engine(OPT_TINY, params, **kw)
        rids = [eng.submit(list(range(1, 20)), max_new=12),
                eng.submit([4, 2], max_new=12)]
        res = eng.run()
        assert eng.step_traces == 1
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    toks = [t for o in outs[0] for t in o]
    assert len(toks) == 24 and all(0 <= t < OPT_TINY.vocab_size
                                   for t in toks)
    assert len(set(toks)) > 1


def test_compiled_decode_captures_once_per_cache(cuda):
    """make_decode_step(compiled=True) on the card: logits and cache rows
    bit-equal to the eager step, one capture for the cache and another for
    a second cache at the same shape; kv_len outside the cache raises
    before the graph runs. The first call's warm-up and capture tick the
    counters twice the eager step's launches; a replay ticks none, and its
    profile holds the kernels the eager step launched."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.core.tiering import deploy
    from repro_torch.launch import steps
    from repro_torch.models import dense

    raw = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(3),
                     device=cuda)
    p, _ = deploy(raw, rber=1e-4, seed=1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, OPT_TINY.vocab_size, (3, 9))).int().to(cuda)
    prefill = steps.make_prefill_step(OPT_TINY, pad_to=32)
    eager = steps.make_decode_step(OPT_TINY)
    comp = steps.make_decode_step(OPT_TINY, compiled=True)
    last, c_e = prefill(p, {"tokens": toks})
    _, c_c = prefill(p, {"tokens": toks})
    tok = last.argmax(-1)
    for i in range(6):
        batch = {"token": tok, "kv_len": 9 + i}
        before = _counts()
        lg_e, c_e = eager(p, c_e, batch)
        n_eager = _since(before)
        before = _counts()
        if i == 0:
            lg_c, c_c = comp(p, c_c, batch)
            assert _since(before) == {k: 2 * n for k, n in n_eager.items()}
        else:
            (lg_c, c_c), records = _profiled(lambda: comp(p, c_c, batch))
            assert _since(before) == {k: 0 for k in MAIN_KERNELS}
            assert records == n_eager
        assert n_eager["decode_attn"] == OPT_TINY.n_layers
        assert torch.equal(lg_c, lg_e), i
        tok = lg_e.argmax(-1)
    torch.cuda.synchronize()
    assert comp.captures == 1
    for k in ("k", "v"):
        assert torch.equal(c_c[k], c_e[k])
    _, c2 = prefill(p, {"tokens": toks})
    lg2, _ = comp(p, c2, {"token": tok, "kv_len": 9})
    assert comp.captures == 2
    assert bool(torch.isfinite(lg2).all())
    with pytest.raises(ValueError, match="outside"):
        comp(p, c2, {"token": tok, "kv_len": 32})


# --- speculative serving -------------------------------------------------------

def test_ecdp_at_the_verify_lm_head_matches_plain(cuda):
    """The verify lanes' lm_head: M = 4 slots x (k + 1) = 20 rows (a 16-row
    MMA tile and a partial one) over OPT-6.7B's lm_head (4096 x 50272, N
    not a multiple of 128) at RBER 1e-4, within the ECDP bound."""
    rng = np.random.default_rng(20)
    m, k, n = 20, 4096, 50272
    wq, parity, scale = _flash(rng, k, n, 1e-4, seed=11)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         ).to(torch.bfloat16)
    want = ecdp.ecdp_matmul_plain(a, wq, parity, scale, True)
    before = ecdp.ecdp_matmul.launches
    got = ecdp.ecdp_matmul(a.to(cuda), wq.to(cuda), parity.to(cuda),
                           scale.to(cuda))
    torch.cuda.synchronize()
    assert ecdp.ecdp_matmul.launches == before + 1
    mag = (a.float().abs() @ wq.float().abs()) * scale
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    err = (got.cpu() - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_captured_spec_step_replays_bit_equal_to_the_eager_body(cuda,
                                                                drafter):
    """OPT_TINY spec engine on the card (k=4): every replay of the
    captured step, run again as the eager step body from the same state
    and inputs, gives the same tokens, n_emit, logits, verify-lane logits
    and state bit for bit; one capture through slot churn and a second
    wave; the drafts land (accepted > 0 with the n-gram drafter)."""
    from repro_torch.configs import OPT_TINY
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.spec import SpecConfig

    params = dense.init(OPT_TINY, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    kw = {}
    if drafter == "model":
        dcfg = dataclasses.replace(OPT_TINY, name="draft", n_layers=2,
                                   d_model=64, n_heads=2, n_kv_heads=2,
                                   head_dim=32, d_ff=128)
        kw = dict(draft_cfg=dcfg, draft_params=dense.init(
            dcfg, torch.Generator(device=cuda).manual_seed(7), device=cuda))
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=96, rber=1e-4,
                 seed=1, kv_aware=False, device=cuda,
                 spec_cfg=SpecConfig(k=4, drafter=drafter), **kw)
    checked = []

    def check(replay):
        def run():
            state = {k: t.clone() for k, t in eng._state().items()}
            out = [t.clone() for t in replay()]
            after = {k: t.clone() for k, t in eng._state().items()}
            for k, t in eng._state().items():
                t.copy_(state[k])
            again = eng._resident_body()
            for i, (a, b) in enumerate(zip(out, again)):
                assert torch.equal(a, b), (len(checked), i)
            for k, t in eng._state().items():
                if k in ("k", "v"):
                    # padding lanes all write the dump block 0, in no order
                    t, after[k] = t[:, 1:], after[k][:, 1:]
                assert torch.equal(after[k], t), (len(checked), k)
            checked.append(int(eng._dev_in["is_decode"].sum()))
            return again
        return run

    def serve():
        r1 = eng.submit([7, 7, 7, 7, 7], max_new=3)
        r2 = eng.submit(list(range(1, 14)), max_new=16)
        while not eng.requests[r1].done:
            eng.step()
        r3 = eng.submit([2, 2, 2], max_new=12)     # into r1's released slot
        eng.run()
        return [eng.requests[r].out for r in (r1, r2, r3)]

    eng.step()                               # nothing queued: no capture
    eng.submit([1, 2, 1, 2], max_new=2)
    eng.step()                               # the capture
    assert eng.step_traces == 1
    eng._captured.replay = check(eng._captured.replay)
    outs = serve() + serve()
    assert eng.step_traces == 1
    assert [len(o) for o in outs] == [3, 16, 12] * 2
    assert sum(checked) > 0                  # verify steps were replayed
    st = eng.spec_stats()
    assert st["spec_verify_steps"] > 0
    if drafter == "ngram":
        assert st["spec_accepted"] > 0
    np.testing.assert_array_equal(eng.pool.lengths_dev.cpu().numpy(),
                                  eng.pool.lengths)


def test_build_engine_serves_granite_smoke_on_the_card(cuda, tmp_path):
    """``build_engine`` at granite-8b-smoke on the card (RMSNorm, RoPE,
    SwiGLU, GQA: the paged kernel at TR = 16 x 2): one capture, every
    token in the vocabulary. Then ``run_deploy --store`` on the card and
    ``build_engine(store_image=, ckpt=)``: the same greedy tokens and
    logits, bit for bit, as a streamed engine programmed from the same
    params in process."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.launch.deploy import run_deploy
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig
    from repro_torch.store import PageStore

    prompts = [[5, 9, 2, 7], [11, 3, 3, 8, 1, 6], [200, 17, 42]]
    cfg = get_config("granite-8b", smoke=True)

    def run(eng):
        rids = [eng.submit(p, max_new=6) for p in prompts]
        logits = []
        while eng.step():
            logits.append(eng.last_logits.cpu())
        return [eng.requests[r].out for r in rids], logits

    eng = build_engine("granite-8b", device="cuda", sample_cfg=SampleConfig())
    out, _ = run(eng)
    assert eng.step_traces == 1
    assert all(len(o) == 6 and all(0 <= t < cfg.vocab_size for t in o)
               for o in out)
    run_deploy("granite-8b", True, None, str(tmp_path), rber=1e-3,
               store_path=str(tmp_path / "nand.img"), device="cuda")
    # the streamer's stall must not contract the budget: both engines
    # plan the same steps
    adm = AdmissionConfig(token_budget=1024)
    img = build_engine("granite-8b", store_image=str(tmp_path / "nand.img"),
                       ckpt=str(tmp_path), sample_cfg=SampleConfig(),
                       device="cuda")
    img.admission_cfg = adm
    got, got_logits = run(img)
    params = dense.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    ref = Engine(cfg, params, max_slots=4, max_seq=256, rber=1e-3,
                 sample_cfg=SampleConfig(), weight_store=PageStore(),
                 admission_cfg=adm, device=cuda)
    want, want_logits = run(ref)
    assert got == want
    assert len(got_logits) == len(want_logits)
    for a, b in zip(got_logits, want_logits):
        assert torch.equal(a, b)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A deployed tree (FlashWeights, bf16) saved and restored with
    ``device="cuda"``: every leaf on the card, equal to what was saved,
    parity uint8 again."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import _walk, deploy
    from repro_torch.models import dense

    cfg = get_config("granite-8b", smoke=True)
    params = dense.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    tiered, _ = deploy(params, rber=1e-3, seed=1)
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, tiered, {"arch": cfg.name})
    got, extras = mgr.restore(tiered, device="cuda")
    assert extras == {"arch": cfg.name}
    pairs = list(zip(dict(_walk(got)).values(), dict(_walk(tiered)).values()))
    assert len(pairs) == 12
    for g, w in pairs:
        if isinstance(w, FlashWeight):
            assert g.parity.dtype == torch.uint8
            g, w = (g.q, g.parity, g.scale), (w.q, w.parity, w.scale)
        else:
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# --- the expert-grouped ECDP and the resident MoE plane -------------------------

def _grouped_case(rng, counts, k, n, rber, cuda):
    """A bank of len(counts) experts (bit errors planted at ``rber``), rows
    grouped by expert with ``counts`` rows each, bf16 on the card."""
    banks = [_flash(rng, k, n, rber, seed=k + n + e)
             for e in range(len(counts))]
    wq, parity, scale = (torch.stack(t).to(cuda) for t in zip(*banks))
    row_start = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                             dtype=torch.int32, device=cuda)
    a = torch.from_numpy(rng.standard_normal((int(sum(counts)), k),
                                             dtype=np.float32)
                         ).to(torch.bfloat16).to(cuda)
    return a, row_start, wq, parity, scale


# expert row counts: empty experts, one past a 64-row tile (the block
# walks two), all rows in one expert, a decode's few rows; K with an
# 8-row tail, N ragged and N % 16 != 0 (byte loads), the qwen3 bank shapes;
# the offline path's capacity layouts at the qwen3 shapes (every expert's
# C+1 rows: a decode's 2, the 16-row tile; a prefill's 21)
GROUPED_CASES = [([3, 0, 5, 1], 128, 48), ([0, 70, 2, 0, 9], 264, 136),
                 ([0, 0, 40, 0], 520, 264), ([1] * 12, 2048, 768),
                 ([2, 3, 0, 4, 1, 0, 2, 4], 768, 2048),
                 ([5, 17, 0, 64], 1032, 130), ([2] * 32, 2048, 768),
                 ([21] * 8, 768, 2048)]


@pytest.mark.parametrize("counts,k,n", GROUPED_CASES)
@pytest.mark.parametrize("rber", [0.0, 2e-3])
@pytest.mark.parametrize("ecc_on", [True, False])
def test_grouped_ecdp_kernel_matches_plain(cuda, counts, k, n, rber, ecc_on):
    """The grouped kernel against its plain version (the per-expert ECDP
    loop) on every routed row, within the ECDP bound; one counted launch,
    at the M tile ``max_rows`` picks and at the default."""
    from repro_torch.kernels import grouped_ecdp as ge

    rng = np.random.default_rng(sum(counts) * k + n)
    a, rs, wq, parity, scale = _grouped_case(rng, counts, k, n, rber, cuda)
    want = ge.grouped_ecdp_plain(a.cpu(), rs.cpu(), wq.cpu(), parity.cpu(),
                                 scale.cpu(), ecc_on)
    mag = torch.zeros_like(want)
    bounds = rs.tolist()
    for e in range(len(counts)):
        r0, r1 = bounds[e], bounds[e + 1]
        mag[r0:r1] = (a[r0:r1].cpu().float().abs()
                      @ wq[e].cpu().float().abs()) * scale[e].cpu()
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    for max_rows in (max(counts), None):
        before = ge.grouped_ecdp_matmul.launches
        got = ge.grouped_ecdp_matmul(a, rs, wq, parity, scale, ecc_on,
                                     max_rows=max_rows)
        torch.cuda.synchronize()
        assert ge.grouped_ecdp_matmul.launches == before + 1
        err = (got.cpu() - want).abs()
        assert bool((err <= bound).all()), float((err - bound).max())


def test_grouped_ecdp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import grouped_ecdp as ge

    rng = np.random.default_rng(0)
    a, rs, wq, parity, scale = _grouped_case(rng, [1, 2], 64, 32, 0.0, cuda)
    with pytest.raises(TypeError):
        ge.grouped_ecdp_matmul(a.float(), rs, wq, parity, scale)
    with pytest.raises(ValueError):
        ge.grouped_ecdp_matmul(a, rs.cpu(), wq, parity, scale)
    with pytest.raises(ValueError):
        ge.grouped_ecdp_matmul(a.t().contiguous().t(), rs, wq, parity, scale)


def test_moe_engine_replays_one_graph_bit_equal_to_eager(cuda):
    """qwen3-moe-30b-a3b-smoke on the card: the compiled engine captures
    its step once and every replay's logits equal the eager engine's bit
    for bit; the eager engine launches per step 3 grouped ECDP and one
    paged attention a layer and one ECDP (lm_head), and the compiled one's
    counters hold its warm-up and capture, twice that."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_ecdp as ge
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = moe.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    runs = {}
    for compiled in (True, False):
        eng = Engine(cfg, params, max_slots=2, max_seq=96, rber=1e-3,
                     device=cuda, compiled=compiled)
        counts = (ge.grouped_ecdp_matmul.launches, ecdp.ecdp_matmul.launches,
                  pa.paged_attn.launches)
        out, logits = _serve(eng, "slot_churn")
        torch.cuda.synchronize()
        runs[compiled] = dict(out=out, logits=logits, traces=eng.step_traces,
                              launches=[b - a for a, b in zip(counts, (
                                  ge.grouped_ecdp_matmul.launches,
                                  ecdp.ecdp_matmul.launches,
                                  pa.paged_attn.launches))])
    comp, eager = runs[True], runs[False]
    assert comp["traces"] == 1 and eager["traces"] == -1
    assert comp["out"] == eager["out"]
    steps = len(eager["logits"])
    per_step = [3 * cfg.n_layers, 1, cfg.n_layers]
    assert eager["launches"] == [steps * n for n in per_step]
    assert comp["launches"] == [2 * n for n in per_step]
    for i, (got, want) in enumerate(zip(comp["logits"], eager["logits"])):
        assert torch.equal(got, want), (i, float((got - want).abs().max()))


# the other families' offline decode, (arch, prompt tokens, decode steps):
# recurrentgemma's smoke window is 16, so its steps wrap the ring
FAMILY_DECODE = [("rwkv6-3b", 9, 6), ("recurrentgemma-9b", 12, 8),
                 ("seamless-m4t-medium", 6, 6)]


@pytest.mark.parametrize("arch,prompt,steps", FAMILY_DECODE)
def test_family_compiled_decode_replays_bit_equal_to_eager(cuda, arch,
                                                           prompt, steps):
    """make_decode_step(compiled=True) on each of the other families'
    smoke configs, deployed at RBER 1e-4: one capture for the cache (every
    tensor of it), every replay's logits and the cache after them
    bit-equal to the eager step's; the capture's warm-up and capture tick
    the counters twice the eager step's launches, a replay none, and its
    profile holds the kernels the eager step launched."""
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import deploy
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import family_module

    cfg = get_config(arch, smoke=True)
    mod = family_module(cfg.family)
    gen = torch.Generator(device=cuda).manual_seed(4)
    p, _ = deploy(mod.init(cfg, gen, device=cuda), rber=1e-4, seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen,
                         device=cuda)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch = {"src_embeds": torch.randn((2, 10, cfg.d_model),
                                           generator=gen, device=cuda
                                           ).to(torch.bfloat16),
                 "tgt_tokens": toks}
    prefill = tsteps.make_prefill_step(cfg, pad_to=32)
    eager = tsteps.make_decode_step(cfg)
    comp = tsteps.make_decode_step(cfg, compiled=True)
    last, c_e = prefill(p, batch)
    _, c_c = prefill(p, batch)
    tok = last.argmax(-1)
    for i in range(steps):
        b = {"token": tok, "kv_len": prompt + i}
        before = _counts()
        lg_e, c_e = eager(p, c_e, b)
        n_eager = _since(before)
        before = _counts()
        if i == 0:
            lg_c, c_c = comp(p, c_c, b)
            assert _since(before) == {k: 2 * n for k, n in n_eager.items()}
        else:
            (lg_c, c_c), records = _profiled(lambda: comp(p, c_c, b))
            assert _since(before) == {k: 0 for k in MAIN_KERNELS}
            assert records == n_eager
        assert torch.equal(lg_c, lg_e), i
        tok = lg_e.argmax(-1)
    torch.cuda.synchronize()
    assert comp.captures == 1
    assert all(torch.equal(c_c[k], c_e[k]) for k in c_e)
    per_layer = {"rwkv6": 0, "rglru": cfg.n_layers // 3,
                 "encdec": 2 * cfg.n_layers}[cfg.family]
    assert n_eager["decode_attn"] == per_layer


# --- the paged ECDP's expert axis and the streamed MoE plane --------------------

def _slab_case(cuda, rng, counts, k, n, rber, slab, spare=5):
    """A bank of len(counts) experts programmed into a store and uploaded
    into a pool on the card with a shuffled free list; ``slab`` lists the
    bank rows the slab holds, in slab order. Returns (a, row_start of the
    slab, the dense bank on the card, the slab's stacked tables (q_tbl,
    p_slots, s_slots), the pool)."""
    banks = [_flash(rng, k, n, rber, seed=k + n + e)
             for e in range(len(counts))]
    pool, tbls = _paged_pool(cuda, {f"e{e}": banks[e]
                                    for e in range(len(counts))},
                             spare=spare, seed=sum(counts) + k)
    stacked = tuple(torch.stack([tbls[f"e{e}"]["dev"][i] for e in slab])
                    for i in range(3))
    dense = tuple(torch.stack(t).to(cuda) for t in zip(*banks))
    slab_counts = [counts[e] for e in slab]
    row_start = torch.tensor(np.concatenate([[0], np.cumsum(slab_counts)]),
                             dtype=torch.int32, device=cuda)
    a = torch.from_numpy(rng.standard_normal((int(sum(slab_counts)), k),
                                             dtype=np.float32)
                         ).to(torch.bfloat16).to(cuda)
    return a, row_start, dense, stacked, pool


@pytest.mark.parametrize("counts,k,n", GROUPED_CASES)
@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_grouped_paged_ecdp_kernel_matches_plain_and_grouped(cuda, counts, k,
                                                             n, rber):
    """The grouped paged kernel over a slab holding the whole bank: within
    the ECDP bound of its plain version, and bit-equal to the dense grouped
    kernel on the same bytes at the same plan, ECC on and off; one counted
    launch each."""
    from repro_torch.kernels import grouped_ecdp as ge

    rng = np.random.default_rng(sum(counts) * k + n + 7)
    slab = list(range(len(counts)))
    a, rs, dense, (qt, ps, ss), pool = _slab_case(cuda, rng, counts, k, n,
                                                  rber, slab)
    mag = torch.zeros((a.shape[0], n), device=cuda)
    bounds = rs.tolist()
    for e in slab:
        r0, r1 = bounds[e], bounds[e + 1]
        mag[r0:r1] = (a[r0:r1].float().abs() @ dense[0][e].float().abs()) \
            * dense[2][e]
    bound = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
    for ecc_on in (True, False):
        before = pe.grouped_paged_ecdp_matmul.launches
        got = pe.grouped_paged_ecdp_matmul(a, rs, pool.buffer, qt, ps, ss,
                                           (k, n), ecc_on,
                                           max_rows=max(counts))
        torch.cuda.synchronize()
        assert pe.grouped_paged_ecdp_matmul.launches == before + 1
        assert torch.equal(got, ge.grouped_ecdp_matmul(
            a, rs, *dense, ecc_on, max_rows=max(counts)))
        want = pe.grouped_paged_ecdp_plain(a, rs, pool.buffer, qt, ps, ss,
                                           (k, n), ecc_on)
        err = (got - want).abs()
        assert bool((err <= bound).all()), float((err - bound).max())


def test_grouped_paged_ecdp_slab_equals_the_full_bank(cuda):
    """A slab of 3 of 12 experts (a subset in bank order, fewer slab rows
    than routed rows, so ``grouped_plan`` alone would split K otherwise)
    with ``plan_experts`` the bank's 12: the routed rows equal the dense
    grouped kernel's over the full bank bit for bit."""
    from repro_torch.kernels import grouped_ecdp as ge

    counts = [0, 4, 0, 0, 9, 0, 0, 0, 3, 0, 0, 0]
    k, n = 2048, 768
    rng = np.random.default_rng(11)
    slab = [1, 4, 8]
    a, rs, dense, (qt, ps, ss), pool = _slab_case(cuda, rng, counts, k, n,
                                                  0.0, slab)
    full_rs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device=cuda)
    want = ge.grouped_ecdp_matmul(a, full_rs, *dense, False, max_rows=16)
    got = pe.grouped_paged_ecdp_matmul(a, rs, pool.buffer, qt, ps, ss,
                                       (k, n), False, max_rows=16,
                                       plan_experts=len(counts))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_grouped_paged_ecdp_wrapper_rejects_what_the_kernel_does_not_take(
        cuda):
    rng = np.random.default_rng(1)
    a, rs, _, (qt, ps, ss), pool = _slab_case(cuda, rng, [1, 2], 64, 32, 0.0,
                                              [0, 1])
    with pytest.raises(TypeError):
        pe.grouped_paged_ecdp_matmul(a.float(), rs, pool.buffer, qt, ps, ss,
                                     (64, 32))
    with pytest.raises(ValueError):
        pe.grouped_paged_ecdp_matmul(a, rs.cpu(), pool.buffer, qt, ps, ss,
                                     (64, 32))
    with pytest.raises(ValueError):
        pe.grouped_paged_ecdp_matmul(a, rs, pool.buffer, qt.cpu(), ps, ss,
                                     (64, 32))
    with pytest.raises(ValueError):
        pe.grouped_paged_ecdp_matmul(a, rs, pool.buffer, qt[0], ps, ss,
                                     (64, 32))


def test_streamed_moe_engine_logits_equal_resident_on_the_card(cuda):
    """qwen3-moe-30b-a3b-smoke streamed from a page store under a budget
    smaller than its expert tier: every step's logits of the slots that ran
    lanes equal the eager resident engine's bit for bit, the greedy tokens
    are the same, the step launches 3 grouped paged ECDP a layer (and no
    dense grouped ECDP, no plain version), and the cache stays within its
    capacity."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_ecdp as ge
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.store import StreamConfig

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = moe.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    probe = PageStore()
    Engine(cfg, params, max_slots=2, max_seq=96, device=cuda,
           weight_store=probe, stream_cfg=StreamConfig()).close()
    budget = int(probe.total_bytes * 0.8)
    runs = {}
    for streamed in (False, True):
        kw = {}
        if streamed:
            kw = dict(weight_store=PageStore(n_planes=8),
                      stream_cfg=StreamConfig(device_budget_bytes=budget))
        eng = Engine(cfg, params, max_slots=2, max_seq=96, rber=1e-3,
                     device=cuda, compiled=False, **kw)
        before = (ge.grouped_ecdp_matmul.launches,
                  pe.grouped_paged_ecdp_matmul.launches)
        rids = [eng.submit(list(range(33, 52)), max_new=8),
                eng.submit([384, 8, 157], max_new=8)]
        logits, lanes = [], []
        while eng.step():
            logits.append(eng.last_logits.clone())
            lanes.append(eng._host_in["q_lens"].numpy() > 0)
            if streamed:
                assert eng.expert_cache.bytes_used \
                    <= eng.expert_cache.capacity
        torch.cuda.synchronize()
        after = (ge.grouped_ecdp_matmul.launches,
                 pe.grouped_paged_ecdp_matmul.launches)
        runs[streamed] = dict(out=[eng.requests[r].out for r in rids],
                              logits=logits, lanes=lanes,
                              launches=[b - a for a, b in zip(before, after)])
        eng.close()
    res, st = runs[False], runs[True]
    steps = len(res["logits"])
    assert res["launches"] == [3 * cfg.n_layers * steps, 0]
    assert st["launches"] == [0, 3 * cfg.n_layers * steps]
    assert st["out"] == res["out"]
    for i, (got, want, live) in enumerate(zip(st["logits"], res["logits"],
                                              st["lanes"])):
        assert torch.equal(got[live], want[live]), i


# --- training (no kernel of the port's: cuBLAS products, plain torch) ---------

def test_adamw_update_on_the_card_matches_the_cpu(cuda):
    """Three AdamW steps (clipping on, warmup_cosine) from the same bf16
    params on the same f32 grads, on the card and the CPU: moments within
    one f32 ulp plus 2^-18 of their leaf's largest (the global norm sums
    in another order on the card, and the clip scale carries it), params
    within one bf16 ulp."""
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves, tree_map

    rng = np.random.default_rng(0)

    def tree():
        return {"layers": {"w": rng.normal(size=(3, 40, 50)),
                           "ln": rng.normal(size=(3, 50))},
                "head": rng.normal(size=(64, 33))}
    p_cpu = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree())
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    opt = AdamW(lr=warmup_cosine(1e-2, 3, 10))
    s_cpu, s_gpu = opt.init(p_cpu), opt.init(p_gpu)
    for _ in range(3):
        g = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), tree())
        s_cpu = opt.apply_(g, s_cpu, p_cpu)
        s_gpu = opt.apply_(tree_map(lambda t: t.to(cuda), g), s_gpu, p_gpu)
        for a, b in zip(tree_leaves(s_cpu.m) + tree_leaves(s_cpu.v),
                        tree_leaves(s_gpu.m) + tree_leaves(s_gpu.v)):
            b = b.cpu()
            tol = (a.abs() * EPS32 + a.abs().max() * 2.0 ** -18)
            assert bool(((a - b).abs() <= tol).all())
        for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)):
            a, b = a.float(), b.cpu().float()
            assert bool(((a - b).abs() <= a.abs() * 2.0 ** -7).all())


def _step_params_agree(p_cpu, p_gpu, m_cpu, m_gpu, lr) -> None:
    """chip_smoke's 15(c) rule: each param whose first moment has one sign
    on both devices within 2^-7 (|p| + lr) + lr eps (1/|g_cpu| +
    1/|g_card|) (an update is -lr g / (|g| + eps), rounded to bf16)."""
    from repro_torch.optim.adamw import tree_leaves

    for pc, pg, mc, mg in zip(tree_leaves(p_cpu), tree_leaves(p_gpu),
                              tree_leaves(m_cpu), tree_leaves(m_gpu)):
        pc, pg, mg = pc.float(), pg.cpu().float(), mg.cpu()
        same = mc.sign() == mg.sign()
        tol = ((torch.maximum(pc.abs(), pg.abs()) + lr) * 2.0 ** -7
               + lr * 1e-9 * (1 / mc.abs() + 1 / mg.abs()))
        assert bool(((pc - pg).abs() <= tol)[same].all())
        assert float((mc - mg).abs().max()) <= \
            float(mc.abs().max()) * 2.0 ** -4


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_on_the_card_matches_the_cpu(cuda, n_micro):
    """One make_train_step step of granite-8b smoke (4 x 16 tokens) on the
    card and on the CPU from the same params: the loss within 1e-3, the
    first moments within 2^-4 of their leaf's largest, the params under
    _step_params_agree; the card's params are the tensors given, finite,
    none requiring grad."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_config("granite-8b", smoke=True)
    p_cpu = family_module(cfg.family).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    given = tree_leaves(p_gpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW(lr=warmup_cosine(1e-2, 2, 10))
    step = make_train_step(cfg, opt, n_micro=n_micro)
    p_gpu, s_gpu, m_gpu = step(p_gpu, opt.init(p_gpu),
                               {k: v.to(cuda) for k, v in batch.items()})
    p_cpu, s_cpu, m_cpu = step(p_cpu, opt.init(p_cpu), batch)
    assert all(a is b for a, b in zip(tree_leaves(p_gpu), given))
    assert all(bool(torch.isfinite(p).all()) and not p.requires_grad
               for p in given)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= 1e-3
    _step_params_agree(p_cpu, p_gpu, s_cpu.m, s_gpu.m,
                       float(opt._lr(s_cpu.step)))
