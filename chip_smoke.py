#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100): builds the
hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card, serves OPT-6.7B at full
width and depth through them — resident, and streamed from a host page
store under a device budget of half the flash tier — and runs its offline
prefill / decode path; checks the card's engine against the CPU engine, the
streamed engine against the resident one, and the card's prefill / decode
against the CPU's.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device   — CUDA must be present; prints the card's name and power
                limit (nvidia-smi) and builds the kernels.
  2. ecdp     — the ECDP kernel against its plain version at the OPT-6.7B
                flash matmul shapes (wq/wo 4096x4096, w_up 4096x16384,
                w_down 16384x4096, lm_head 4096x50272), M in {4, 64, 512},
                RBER 0 and 2e-3, ECC on and off; times at the serving shapes
                and at prefill's M=512 (w_up, w_down, lm_head). The kernels
                line carries the registers, spills (ptxas's build log) and
                shared memory per block (static + dynamic) of each bf16
                (tensor-core) instantiation.
  3. paged    — the paged-attention kernel against its plain version and
                its plain version in the kernel's order (the bounds are
                stated at kernel_errors in kernels/paged_attn.py) at B=4,
                KV=32, TR=16, Dh=128, block 16 over scrambled block tables,
                at ragged contexts (0 .. 2047) and at contexts the resident
                run has (96 .. 544); each timed beside SDPA. The kernels
                line carries the registers, spills and shared memory per
                block of each instantiation (no spills allowed).
  4. serving  — Engine(OPT_6_7B) on the card: seeded init, deploy at RBER
                1e-4, full width and depth, 4 slots, max_seq 2048, chunk
                16; 6 requests (prompts 7..512 tokens, 32 new each) run to
                completion. The kernels' launch counters are zeroed just
                before and read just after: ECDP = steps x (32 x 4 + 1),
                paged attention = steps x 32. Then the same requests again:
                8 steps, 12 timed steps, 12 steps traced with
                torch.profiler (device time per kernel group, idle share);
                and one step's 129 flash matmuls replayed back to back on
                the engine's weights (the ECDP times of the kernels line).
  5. parity   — the same seeded engine at OPT-6.7B width cut to 2 layers,
                on the card (kernels) and on the CPU (plain versions):
                byte-identical deploy, per-step logits within 2^-6 of the
                row's largest logit, greedy tokens wherever the top-2
                margin exceeds twice that.
  6. paged    — the paged-ECDP kernel against its plain version (the ECDP
                bound) and against the ECDP kernel on the same dense bytes
                (bit-equal: same kernel body, same K split) at the OPT-6.7B
                paged shapes (wq/wo 4096x4096, w_up 4096x16384, w_down
                16384x4096) and two ragged ones (200x72, 136x384), M in
                {4, 64}, RBER 0 and 2e-3, ECC on and off, over page tables
                scrambled by a shuffled free list; times per launch at the
                serving shapes and one layer's four paged calls back to
                back.
  7. streamed — Engine(OPT_6_7B) at full width and depth, seeded init,
                RBER 1e-4, its flash tier programmed into PageStore(
                n_planes=32) and streamed under StreamConfig(group_size=1,
                prefetch_depth=2, device_budget_bytes = half the tier); 4
                requests (prompts 7..200 tokens, 16 new each). The launch
                counters are zeroed just before and read just after:
                paged ECDP = steps x 32 x 4, ECDP = steps (lm_head), paged
                attention = steps x 32. Then a resident engine on the same
                params serves the same requests: every step's logits must
                equal the streamed engine's bit for bit.
  8. offline  — the dense model's own prefill / decode_step on OPT-6.7B.
                (a) the decode-attention kernel against its plain version
                and its plain version in the kernel's order (bounds at
                kernel_errors in kernels/decode_attn.py) at the OPT-6.7B
                decode shape (B=4, S_max=2048, KV=32, rep=1, Dh=128,
                lengths 0, 1, 513, 2048), GQA (KV=8, rep=4) and MQA
                (S_max=1000), bf16 and f32 caches; timed against SDPA.
                (b) seeded init at full width and depth, deploy at RBER
                1e-4, 4 prompts of 128 tokens prefilled into a cache padded
                to 2048, 32 greedy decode steps; launch counters zeroed just
                before and read just after: decode attention = 32 x steps,
                ECDP = 65 x (1 + steps); then 8 decode steps timed and 8
                traced with torch.profiler. (c) OPT-6.7B width cut to 2
                layers on the card and the CPU: byte-identical deploy,
                prefill and 8 decode steps' logits within 2^-6 of the row's
                largest logit, greedy tokens wherever the top-2 margin
                exceeds twice that; teacher-forced decode against forward on
                the card within the same bound.

The second-to-last line is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Times are CUDA-event medians with the
L2 cache flushed before each timed call (the serving step streams more
weight bytes than L2 holds) and the card held while the call is enqueued
(``Timer``). bound_ms is the larger of the bytes a call
must move at 3.35 TB/s and its operations at the bf16 tensor-core peak of
989 TFLOP/s (H100 SXM data sheet, 700 W). In the kernels line ``ms`` and
``kernel_ms`` are the same number under the two names it is read by.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
EPS32 = 2.0 ** -23


def log(*args):
    print(*args, flush=True)


def resources_row(res: dict, smem_dynamic: int, **key) -> dict:
    """One kernel instantiation's ptxas report (``build.resources``) with
    the dynamic shared memory it is launched with."""
    return dict(key, registers=res["registers"],
                spill_stores=res["spill_stores"],
                spill_loads=res["spill_loads"], smem_static=res["smem"],
                smem_dynamic=smem_dynamic, smem=res["smem"] + smem_dynamic)


def mma_resources(build, name: str) -> list[dict]:
    """Registers, spills and shared memory per block of each tensor-core
    instantiation (ecdp_mma_kernel<M tile, wide, W>) of kernel library
    ``name``: ptxas's report, plus the dynamic shared memory it is
    launched with (the body's, the same in both libraries)."""
    import re
    smem_fn = build.load("ecdp").ecdp_mma_smem_bytes
    out = []
    for fn, res in build.resources(name).items():
        m = re.search(r"ecdp_mma_kernelILi(\d+)ELb([01])E", fn)
        if m:
            m_tile = int(m.group(1))
            out.append(resources_row(res, smem_fn(m_tile), m_tile=m_tile,
                                     wide=m.group(2) == "1"))
    return sorted(out, key=lambda r: (r["m_tile"], r["wide"]))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """CUDA-event time of one call, median over reps, L2 flushed first. A
    spin kernel of about 1 ms holds the card while the host enqueues the
    start event and the call, so a call that is short on the card is not
    timed with its host-side dispatch (the start event would otherwise run
    as soon as the flush ends, before the call is enqueued)."""

    HOLD_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush_l2(self):
        """Evict L2 by writing the 256 MiB buffer. The lines it leaves in L2
        are dirty: a call that misses in L2 pays their write-back."""
        self.flush.zero_()

    def __call__(self, fn, reps: int = 10, warmup: int = 2,
                 hold: int = HOLD_CYCLES) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_l2()
            torch.cuda._sleep(hold)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


# --- phase 2: ECDP ------------------------------------------------------------

ECDP_SHAPES = {"wq/wo": (4096, 4096), "w_up": (4096, 16384),
               "w_down": (16384, 4096), "lm_head": (4096, 50272)}
# M of each shape's flash matmul in a serving step: slots x chunk = 64 for
# the layers' weights, slots = 4 for lm_head
ECDP_M = {"wq/wo": 64, "w_up": 64, "w_down": 64, "lm_head": 4}
# prefill of 4 prompts of 128 tokens (phase 8) sends M = 512 rows through
# the FFN and lm_head; timed there too
PREFILL_M = 512


def phase_ecdp(torch, timer):
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_abs = worst_rel = 0.0
    per_shape = {}
    for name, (k, n) in ECDP_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        flash = {r: encode_flash(w, rber=r, seed=k + n) for r in (0.0, 2e-3)}
        w_deq = dequantize_int8(flash[0.0].q, flash[0.0].scale)
        del w
        for m in (4, 64, PREFILL_M):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            for rber, fw in flash.items():
                for ecc_on in (True, False):
                    got = ecdp_matmul(a, fw.q, fw.parity, fw.scale, ecc_on)
                    want = ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale,
                                             ecc_on)
                    torch.cuda.synchronize()
                    # same integer weights, f32 sums in another order
                    mag = (a.float().abs() @ fw.q.float().abs()) * fw.scale
                    tol = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
                    err = (got - want).abs()
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"ecdp {name} M={m} rber={rber} ecc={ecc_on}: "
                            f"max err {float(err.max())}")
                    worst_abs = max(worst_abs, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / want.abs().clamp_min(1e-3)).max()))
            if m != ECDP_M[name] and not (m == PREFILL_M
                                          and name != "wq/wo"):
                continue
            fw = flash[2e-3]
            t_kernel = timer(lambda: ecdp_matmul(a, fw.q, fw.parity,
                                                 fw.scale, True))
            t_plain = timer(lambda: ecdp_matmul_plain(a, fw.q, fw.parity,
                                                      fw.scale, True), reps=3)
            t_lib = timer(lambda: torch.matmul(a, w_deq))
            nbytes = k * n * 9 / 8 + 4 * n + 2 * m * k + 4 * m * n
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
            key = name if m == ECDP_M[name] else f"{name}@M{m}"
            per_shape[key] = dict(m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=b_ms,
                                  bound_by=b_by)
            log(f"  ecdp {name:8s} M={m:3d} K={k:5d} N={n:5d}: kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul "
                f"bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del flash, w_deq
    log(f"  ecdp vs plain: max abs err {worst_abs:.3e}, max rel err "
        f"{worst_rel:.3e} (48 cases)")
    return dict(max_abs_err=worst_abs, per_launch=per_shape)


# --- phase 3: paged attention ----------------------------------------------------

# (B, KV, TR, Dh, block size, table width) of one layer of the serving step
PAGED_SHAPE = (4, 32, 16, 128, 16, 128)
PAGED_CTX = [0, 2047, 513, 1200]          # ragged, an empty slot, a long one
# contexts phase 4's resident run has mid-run (prompts 7..512 + 32 new,
# chunk 16)
PAGED_SERVING_CTX = [96, 544, 215, 146]


def paged_resources(build) -> list[dict]:
    """Registers, spills and shared memory per block of each instantiation
    (paged_attn_split_kernel<Dh, k16 tiles per chunk>) and of the merge
    kernel: ptxas's report, plus the dynamic shared memory the split
    kernel is launched with at KV >= 4."""
    import re
    smem_fn = build.load("paged_attn").paged_attn_smem_bytes
    out = []
    for fn, res in build.resources("paged_attn").items():
        m = re.search(r"paged_attn_split_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            dh, nt = int(m.group(1)), int(m.group(2))
            out.append(resources_row(res, smem_fn(4, dh, 16 * nt),
                                     kernel="split", dh=dh, k16_tiles=nt))
        elif "paged_attn_merge_kernel" in fn:
            out.append(resources_row(res, 0, kernel="merge"))
    return sorted(out, key=lambda r: (r["kernel"], r.get("dh", 0),
                                      r.get("k16_tiles", 0)))


def phase_paged(torch, timer):
    """The kernel against its plain versions at PAGED_SHAPE with PAGED_CTX
    and PAGED_SERVING_CTX over scrambled tables; each timed beside its
    plain version and SDPA on the K/V gathered through the tables."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import (kernel_errors, paged_attn,
                                                paged_attn_plain)

    b, n_kv, tr, dh, bs, max_blocks = PAGED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_blocks = 1 + b * max_blocks

    def table(ctx):
        perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
        tables = torch.zeros((b, max_blocks), dtype=torch.int32,
                             device="cuda")
        pi = 0
        for i, c in enumerate(ctx):
            nb = -(-c // bs)
            tables[i, :nb] = perm[pi:pi + nb].int()
            pi += nb
        return tables

    def bf(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    ragged = table(PAGED_CTX)
    q = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k_pool, v_pool = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    rows = {}
    for name, ctx, tables in (
            ("ragged", PAGED_CTX, ragged),
            ("serving", PAGED_SERVING_CTX, table(PAGED_SERVING_CTX))):
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        acc, m, l = paged_attn(q, k_pool, v_pool, tables, lens)
        torch.cuda.synchronize()
        # each check's error over its bound (stated at kernel_errors)
        errs = kernel_errors(q, k_pool, v_pool, tables, lens, acc, m, l)
        max_abs = errs.pop("max_abs_err")
        if not all(v <= 1 for v in errs.values()):
            raise AssertionError(f"paged attention, ctx {ctx}: error / bound "
                                 f"{errs}")
        log(f"  paged_attn ctx={ctx} error / bound: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
        t_kernel = timer(lambda: paged_attn(q, k_pool, v_pool, tables, lens))
        t_plain = timer(lambda: paged_attn_plain(q, k_pool, v_pool, tables,
                                                 lens), reps=3)
        # yardstick: SDPA over the K/V gathered through the tables
        s_pad = max_blocks * bs
        kg = k_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
            1, 2).contiguous()
        vg = v_pool[tables.long()].reshape(b, s_pad, n_kv, dh).transpose(
            1, 2).contiguous()
        mask = (torch.arange(s_pad, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        t_lib = timer(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, scale=1.0))
        live = sum(ctx)
        nbytes = (live * n_kv * dh * 2 * 2 + q.numel() * 2 + acc.numel() * 4
                  + 2 * m.numel() * 4 + tables.numel() * 4 + b * 4)
        b_ms, b_by = bound_ms(nbytes, 4.0 * tr * dh * n_kv * live)
        log(f"  paged_attn B={b} KV={n_kv} TR={tr} Dh={dh} ctx={ctx}: kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, SDPA {t_lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); max abs err {max_abs:.3e}")
        rows[name] = dict(ctx=ctx, max_abs_err=max_abs, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                          bound_by=b_by)
        del kg, vg
    return rows


# --- phase 6: paged ECDP -------------------------------------------------------------

PAGED_SHAPES = {"wq/wo": (4096, 4096), "w_up": (4096, 16384),
                "w_down": (16384, 4096), "ragged 200x72": (200, 72),
                "ragged 136x384": (136, 384)}
PAGED_SERVING = ("wq/wo", "w_up", "w_down")   # M = slots x chunk = 64


def phase_paged_ecdp(torch, timer):
    import numpy as np

    from repro_torch.core.quant import dequantize_int8
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels.ecdp import ecdp_matmul
    from repro_torch.kernels.paged_ecdp import (gather_q, gather_scale,
                                                paged_ecdp_matmul,
                                                paged_ecdp_matmul_plain)
    from repro_torch.store import PageStore, WeightPagePool

    gen = torch.Generator(device="cuda").manual_seed(6)
    store, dense = PageStore(), {}
    for name, (k, n) in PAGED_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        for rber in (0.0, 2e-3):
            dense[(name, rber)] = encode_flash(w, rber=rber, seed=k + n)
            store.put(f"{name}@{rber}", dense[(name, rber)])
        del w
    names = list(store.table)
    n_pages = sum(store.entry_pages(x) for x in names) + 97
    pool = WeightPagePool(store, n_pages, device="cuda")
    # scrambled page tables: slots from a shuffled free list
    pool._free = [int(s) for s in
                  np.random.default_rng(6).permutation(n_pages)]
    tbls = pool.upload(names)
    torch.cuda.synchronize()

    def paged(name, rber):
        t = tbls[f"{name}@{rber}"]
        return (pool.buffer, *t["dev"], t["kn"])

    worst_abs = worst_rel = 0.0
    cases = 0
    per_launch, acts = {}, {}
    for name, (k, n) in PAGED_SHAPES.items():
        for m in (4, 64):
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            acts[(name, m)] = a
            for rber in (0.0, 2e-3):
                fw = dense[(name, rber)]
                for ecc_on in (True, False):
                    got = paged_ecdp_matmul(a, *paged(name, rber), ecc_on)
                    want = paged_ecdp_matmul_plain(a, *paged(name, rber),
                                                   ecc_on)
                    same = ecdp_matmul(a, fw.q, fw.parity, fw.scale, ecc_on)
                    torch.cuda.synchronize()
                    if not torch.equal(got, same):
                        raise AssertionError(
                            f"paged ecdp {name} M={m} rber={rber} "
                            f"ecc={ecc_on}: differs from the ECDP on the "
                            f"same bytes by {float((got - same).abs().max())}")
                    mag = (a.float().abs() @ fw.q.float().abs()) * fw.scale
                    tol = 1e-4 + 4 * math.sqrt(k) * EPS32 * mag
                    err = (got - want).abs()
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"paged ecdp {name} M={m} rber={rber} "
                            f"ecc={ecc_on}: max err {float(err.max())}")
                    worst_abs = max(worst_abs, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / want.abs().clamp_min(1e-3)).max()))
                    cases += 1
        if name not in PAGED_SERVING:
            continue
        m, a, args = 64, acts[(name, 64)], paged(name, 2e-3)
        t_kernel = timer(lambda: paged_ecdp_matmul(a, *args))
        t_plain = timer(lambda: paged_ecdp_matmul_plain(a, *args), reps=3)
        # yardstick: torch.matmul on the gathered, dequantised bf16 weight
        w_deq = dequantize_int8(gather_q(args[0], args[1], k, n),
                                gather_scale(args[0], args[3], n))
        t_lib = timer(lambda: torch.matmul(a, w_deq))
        del w_deq
        nbytes = k * n * 9 / 8 + 4 * n + 2 * m * k + 4 * m * n
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
        per_launch[name] = dict(m=m, k=k, n=n, ms=t_kernel,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by)
        log(f"  paged ecdp {name:7s} M={m} K={k:5d} N={n:5d}: kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul bf16 "
            f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"  paged ecdp vs plain: max abs err {worst_abs:.3e}, max rel err "
        f"{worst_rel:.3e}; bit-equal to the ECDP on the same bytes "
        f"({cases} cases)")
    layer = time_paged_layer(torch, timer, pool, tbls, acts)
    del pool, tbls, dense, acts
    return dict(max_abs_err=worst_abs, per_launch=per_launch, layer=layer)


def time_paged_layer(torch, timer, pool, tbls, acts):
    """One layer's four paged calls as the streamed step makes them (wq,
    wo, w_up, w_down at M=64, four distinct weights) back to back: the
    kernel, its plain version and torch.matmul on the dequantised
    weights."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.paged_ecdp import (gather_q, gather_scale,
                                                paged_ecdp_matmul,
                                                paged_ecdp_matmul_plain)

    calls = []
    for name, rber in (("wq/wo", 0.0), ("wq/wo", 2e-3), ("w_up", 2e-3),
                       ("w_down", 2e-3)):
        t = tbls[f"{name}@{rber}"]
        calls.append((acts[(name, 64)], (pool.buffer, *t["dev"], t["kn"])))
    t_kernel = timer(lambda: [paged_ecdp_matmul(a, *x) for a, x in calls])
    t_plain = timer(lambda: [paged_ecdp_matmul_plain(a, *x)
                             for a, x in calls], reps=3)
    w_deq = [dequantize_int8(gather_q(x[0], x[1], *x[4]),
                             gather_scale(x[0], x[3], x[4][1]))
             for _, x in calls]
    t_lib = timer(lambda: [torch.matmul(a, w) for (a, _), w in
                           zip(calls, w_deq)])
    del w_deq
    nbytes = sum(k * n * 9 / 8 + 4 * n + 2 * a.shape[0] * k
                 + 4 * a.shape[0] * n for a, (*_, (k, n)) in calls)
    flops = sum(2.0 * a.shape[0] * k * n for a, (*_, (k, n)) in calls)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  paged ecdp, one layer's 4 calls back to back: kernel "
        f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul bf16 "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


# --- phase 7: streamed serving ------------------------------------------------------

STREAM_PROMPTS, STREAM_NEW = (7, 40, 120, 200), 16


def _payload(k: int, n: int) -> int:
    """Store payload bytes of one (K, N) flash weight: q, parity, scales."""
    return k * n + (k // 8) * n + 4 * n


def phase_streamed(torch):
    import resource

    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import PageStore, StreamConfig

    cfg = OPT_6_7B
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    tier = cfg.n_layers * (_payload(d, f) + _payload(f, d)
                           + 4 * _payload(d, d)) + _payload(d, v)
    stream_cfg = StreamConfig(group_size=1, prefetch_depth=2,
                              device_budget_bytes=tier // 2)
    # token_budget 1024: the budget contracted by Algorithm 2 and the
    # streamer's stall (at worst 1024 x 0.25 x 0.25 = 64 lanes) never
    # binds below the 4 x 16 lanes the slots can use, so the streamed and
    # the resident engine plan the same steps and their logits compare
    kw = dict(max_slots=4, max_seq=256, rber=1e-4, seed=0,
              admission_cfg=AdmissionConfig(chunk_tokens=16,
                                            token_budget=1024),
              device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, v, n).tolist() for n in STREAM_PROMPTS]

    def params():
        return dense.init(cfg, torch.Generator(device="cuda").manual_seed(5),
                          device="cuda")

    t0 = time.perf_counter()
    store = PageStore(n_planes=32)
    eng = Engine(cfg, params(), weight_store=store, stream_cfg=stream_cfg,
                 **kw)
    gc.collect()
    torch.cuda.synchronize()
    assert store.total_bytes == tier > stream_cfg.device_budget_bytes
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  init + program the store ({cfg.n_layers} layers, full width): "
        f"{time.perf_counter() - t0:.1f} s; store {store.n_pages} pages, "
        f"{store.image_bytes / 2**30:.2f} GiB image ({tier / 2**30:.2f} GiB "
        f"payload; numpy array {store._data.nbytes / 2**30:.2f} GiB), "
        f"budget {stream_cfg.device_budget_bytes / 2**30:.2f} GiB, pool "
        f"{eng.wpool.n_pages} pages; peak host RSS so far {rss / 2**30:.2f}"
        f" GiB; device {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rids = [eng.submit(p, max_new=STREAM_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = []
    ecdp.ecdp_matmul.launches = 0
    paged_ecdp.paged_ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    t0 = time.perf_counter()
    while eng.step():
        logits.append(eng.last_logits.cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_ecdp": paged_ecdp.paged_ecdp_matmul.launches,
                "ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = len(logits)
    st = eng.stream_stats()
    out = {rid: list(eng.requests[rid].out) for rid in rids}
    assert all(len(o) == STREAM_NEW and all(0 <= x < v for x in o)
               for o in out.values())
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    assert launches == {"paged_ecdp": steps * cfg.n_layers * 4,
                        "ecdp": steps, "paged_attn": steps * cfg.n_layers}, \
        (launches, steps)
    assert st["bytes_streamed"] > 0 and st["pool_grows"] == 0
    assert st["pool_uploads"] == st["groups_streamed"], st
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident, (eng.wpool.used_pages, resident)
    stalls = [s["stall_frac"] for s in eng.stats]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  streamed: {len(rids)} requests (prompts {list(STREAM_PROMPTS)}, "
        f"{STREAM_NEW} new each) in {steps} steps, {wall:.2f} s: "
        f"{wall / steps * 1e3:.1f} ms/step; launches {launches}")
    log(f"  streamed {st['groups_streamed']} windows, "
        f"{st['bytes_streamed'] / steps / 2**30:.3f} GiB/step; host-to-device"
        f" copies {st['pool_bytes_staged'] / 2**30:.2f} GiB in "
        f"{st['pool_h2d_s']:.3f} s = "
        f"{st['pool_bytes_staged'] / max(st['pool_h2d_s'], 1e-9) / 1e9:.2f}"
        f" GB/s; worker read+upload {st['stream_s']:.2f} s = "
        f"{st['bytes_streamed'] / max(st['stream_s'], 1e-9) / 1e9:.2f} GB/s"
        f"; consumer stall {st['stall_s']:.2f} s; stall_frac last "
        f"{stalls[-1]:.3f}, mean {sum(stalls) / len(stalls):.3f}; cache "
        f"hits {st['cache_hits']} misses {st['cache_misses']} evictions "
        f"{st['cache_evictions']}; NAND model {st['nand_seconds']:.3f} s")
    log(f"  peak device memory while serving {peak / 2**30:.2f} GiB (pool "
        f"{eng.wpool.n_pages * store.page_bytes / 2**30:.2f} GiB); peak host"
        f" RSS {rss / 2**30:.2f} GiB, store array "
        f"{store._data.nbytes / 2**30:.2f} GiB")
    stream_ms = wall / steps * 1e3
    del eng, store
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = Engine(cfg, params(), **kw)
    gc.collect()
    log(f"  resident reference built in {time.perf_counter() - t0:.1f} s")
    rids_r = [res.submit(p, max_new=STREAM_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, lg in enumerate(logits):
        assert res.step() > 0
        got = res.last_logits.cpu()
        if not torch.equal(got, lg):
            raise AssertionError(
                f"step {i}: streamed logits differ from the resident "
                f"engine's by {float((got - lg).abs().max())}")
    assert res.step() == 0
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    assert [res.requests[r].out for r in rids_r] == [out[r] for r in rids]
    log(f"  resident: {steps} steps, {wall_r / steps * 1e3:.1f} ms/step; "
        f"logits bit-equal to the streamed engine's at all {steps} steps")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, launches=launches, ms_per_step=stream_ms,
                resident_ms_per_step=wall_r / steps * 1e3)


# --- phase 4: serving -----------------------------------------------------------

PROFILE_WARMUP, PROFILE_STEPS = 8, 12
PROFILE_GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("ecdp kernel", ("ecdp_",)),
    ("paged attention kernel", ("paged_attn_",)),
    ("decode attention kernel", ("decode_attn_",)),
    ("GEMM (DRAM projections)", ("gemm", "cutlass", "sm90_", "ampere_",
                                 "cublas", "nvjet")),
    ("elementwise / reduction / copy", ("elementwise", "reduce", "copy",
                                        "index", "cat", "gather", "scatter",
                                        "fill", "softmax", "norm")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_steps(torch, eng, prompts):
    """The same requests again: PROFILE_WARMUP steps, then trace_steps over
    PROFILE_STEPS engine steps."""
    for p in prompts:
        eng.submit(p, max_new=32)
    for _ in range(PROFILE_WARMUP):
        eng.step()
    trace_steps(torch, eng.step, PROFILE_STEPS)


def trace_steps(torch, step, n_steps: int) -> dict:
    """``n_steps`` calls of ``step`` timed on the host clock, then
    ``n_steps`` more traced with torch.profiler. Prints the device time per
    kernel group and the idle share, 1 - device time / wall time, against
    the untraced steps' wall time (adjacent steps; the profiler's own host
    cost inflates the traced wall time, whose share is printed beside
    it). Returns the untraced ms/step, device ms/step and the groups'."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_traced = (time.perf_counter() - t0) / n_steps
    groups: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        groups[_group(evt.key)] = groups.get(_group(evt.key), 0.0) + dev_us
        kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us
    busy = sum(groups.values()) / 1e6 / n_steps
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"  profile: {n_steps} untraced steps {wall * 1e3:.2f} ms/step;"
        f" {n_steps} traced steps {wall_traced * 1e3:.2f} ms/step, "
        f"device {busy * 1e3:.2f} ms/step; idle share {1 - busy / wall:.3f} "
        f"(untraced wall), {1 - busy / wall_traced:.3f} (traced wall)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:32s} {us / 1e3 / n_steps:9.3f} ms/step "
            f"{us / 1e6 / n_steps / busy:6.1%}")
    log("  top kernels (device ms/step):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3 / n_steps:9.3f}  {name[:90]}")
    return dict(ms_per_step=wall * 1e3, device_ms_per_step=busy * 1e3,
                groups_ms={g: us / 1e3 / n_steps for g, us in groups.items()})


def ecdp_step_calls(eng):
    """One serving step's flash matmuls as (M, FlashWeight), in the step's
    order: per layer wq, wo, w_up, w_down at M = slots x chunk; lm_head at
    M = slots."""
    m = eng.pool.n_slots * eng.admission_cfg.chunk_tokens
    calls = []
    for li, lp in enumerate(eng._layers):
        fl = eng.attn_flash[li]
        calls += [(m, fl["wq"]), (m, fl["wo"]), (m, lp["ffn"]["w_up"]),
                  (m, lp["ffn"]["w_down"])]
    return calls + [(eng.pool.n_slots, eng.params["lm_head"])]


def time_ecdp_step(torch, timer, calls):
    """The step's flash matmuls back to back on the engine's own weights
    (distinct per layer, so nothing stays in L2): the kernel, its plain
    version, and torch.matmul on the dequantised bf16 weights."""
    from repro_torch.core.quant import dequantize_int8
    from repro_torch.kernels.ecdp import ecdp_matmul, ecdp_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    acts = {}
    for m, fw in calls:
        if (m, fw.q.shape[0]) not in acts:
            acts[(m, fw.q.shape[0])] = torch.randn(
                (m, fw.q.shape[0]), generator=gen, device="cuda"
            ).to(torch.bfloat16)
    args = [(acts[(m, fw.q.shape[0])], fw) for m, fw in calls]
    # the card held for about 15 ms while the host enqueues the 129 calls,
    # so the time is the card's, not the host's dispatch
    hold = 30_000_000
    t_kernel = timer(lambda: [ecdp_matmul(a, fw.q, fw.parity, fw.scale, True)
                              for a, fw in args], reps=5, hold=hold)
    t_plain = timer(lambda: [ecdp_matmul_plain(a, fw.q, fw.parity, fw.scale,
                                               True) for a, fw in args],
                    reps=1, warmup=1)
    w_deq = [dequantize_int8(fw.q, fw.scale) for _, fw in args]
    t_lib = timer(lambda: [torch.matmul(a, w) for (a, _), w in
                           zip(args, w_deq)], reps=5, hold=hold)
    del w_deq
    nbytes = sum(fw.q.numel() * 9 / 8 + fw.scale.numel() * 4 + a.numel() * 2
                 + 4 * a.shape[0] * fw.q.shape[1] for a, fw in args)
    flops = sum(2.0 * a.shape[0] * fw.q.numel() for a, fw in args)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  ecdp, one step's {len(calls)} flash matmuls back to back: kernel "
        f"{t_kernel:.3f} ms, plain {t_plain:.3f} ms, torch.matmul bf16 "
        f"{t_lib:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


def phase_serving(torch, timer):
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.scheduler import AdmissionConfig
    from repro_torch.kernels import ecdp, paged_attn
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    cfg = OPT_6_7B
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dense.init(cfg, gen, device="cuda")
    eng = Engine(cfg, params, max_slots=4, max_seq=2048, rber=1e-4, seed=0,
                 admission_cfg=AdmissionConfig(chunk_tokens=16,
                                               token_budget=64),
                 device="cuda")
    del params
    gc.collect()
    torch.cuda.synchronize()
    log(f"  init + deploy {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    rng = np.random.default_rng(0)
    lens = [7, 64, 200, 512, 33, 130]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    rids = [eng.submit(p, max_new=32) for p in prompts]
    ecdp.ecdp_matmul.launches = 0
    paged_attn.paged_attn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ecdp": ecdp.ecdp_matmul.launches,
                "paged_attn": paged_attn.paged_attn.launches}
    steps = len(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    for rid in rids:
        toks = out[rid]
        assert len(toks) == 32, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks)
    assert bool(torch.isfinite(eng.last_logits).all())
    calls = ecdp_step_calls(eng)
    assert len(calls) == cfg.n_layers * 4 + 1
    assert launches["ecdp"] == steps * len(calls), launches
    assert launches["paged_attn"] == steps * cfg.n_layers, launches
    generated = 32 * len(rids)
    processed = sum(s["prefill_tokens"] + s["decode_tokens"]
                    for s in eng.stats)
    log(f"  served {len(rids)} requests (prompts {lens}, 32 new each) in "
        f"{steps} steps, {wall:.2f} s: {generated / wall:.1f} generated "
        f"tokens/s, {processed / wall:.1f} processed tokens/s, "
        f"{wall / steps * 1e3:.1f} ms/step")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}; "
        f"final npu_fraction {eng.stats[-1]['npu_fraction']}")
    log(f"  first request's tokens: {out[rids[0]][:12]}")
    profile_steps(torch, eng, prompts)
    ecdp_step = time_ecdp_step(torch, timer, calls)
    del eng, calls
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, wall_s=wall, launches=launches, peak_bytes=peak,
                ecdp_step=ecdp_step)


# --- phase 5: engine parity, card vs CPU -------------------------------------------

# Card vs CPU logits differ where a bf16 rounding of an activation lands
# one ulp apart after f32 sums in another order; lm_head reads a bf16
# hidden state, so the bound is relative to the row's largest logit: four
# bf16 unit roundoffs (4 * 2^-8).
PARITY_REL_TOL = 2.0 ** -6


def phase_parity(torch):
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import FlashWeight, _walk
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(OPT_6_7B, n_layers=2, name="opt-6.7b-2l")
    t0 = time.perf_counter()
    params = dense.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    kw = dict(max_slots=2, max_seq=64, rber=1e-4, seed=1)
    eng_cpu = Engine(cfg, params, device="cpu", **kw)
    eng_gpu = Engine(cfg, params, device="cuda", **kw)
    del params
    log(f"  {cfg.name}: built both engines in {time.perf_counter() - t0:.1f}"
        " s (cut: 2 of 32 layers; widths as OPT-6.7B)")
    # the flash tier is integer work: byte-identical on both devices
    pairs = list(zip(dict(_walk(eng_gpu.params)).values(),
                     dict(_walk(eng_cpu.params)).values()))
    pairs += [(g[k], c[k]) for g, c in zip(eng_gpu.attn_flash,
                                           eng_cpu.attn_flash) for k in g]
    n_flash = 0
    for g, c in pairs:
        if isinstance(g, FlashWeight):
            n_flash += 1
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 9).tolist(),
               rng.integers(0, cfg.vocab_size, 21).tolist()]
    for e in (eng_cpu, eng_gpu):
        for p in prompts:
            e.submit(p, max_new=4)
    max_diff, max_rel, compared, diverged = 0.0, 0.0, 0, set()
    t0 = time.perf_counter()
    while True:
        n_out = {rid: len(r.out) for rid, r in eng_cpu.requests.items()}
        n_cpu, n_gpu = eng_cpu.step(), eng_gpu.step()
        assert n_cpu == n_gpu
        if n_cpu == 0:
            break
        lg_cpu, lg_gpu = eng_cpu.last_logits, eng_gpu.last_logits.cpu()
        for rid, req in eng_cpu.requests.items():
            if rid in diverged or len(req.out) == n_out[rid]:
                continue                     # sampled nothing this step
            row = req.slot
            diff = float((lg_cpu[row] - lg_gpu[row]).abs().max())
            tol = PARITY_REL_TOL * float(lg_cpu[row].abs().max())
            max_diff = max(max_diff, diff)
            max_rel = max(max_rel, diff / float(lg_cpu[row].abs().max()))
            assert diff <= tol, (rid, diff, tol)
            top2 = torch.topk(lg_cpu[row], 2).values
            t_cpu = req.out[-1]
            t_gpu = eng_gpu.requests[rid].out[-1]
            if float(top2[0] - top2[1]) > 2 * tol:
                assert t_cpu == t_gpu, (rid, t_cpu, t_gpu)
                compared += 1
            elif t_cpu != t_gpu:
                diverged.add(rid)            # a near-tie broke differently
    log(f"  parity over {len(eng_cpu.stats)} steps in "
        f"{time.perf_counter() - t0:.1f} s: {n_flash} flash weights "
        f"byte-identical, max |logit diff| {max_diff:.3e} = {max_rel:.3e} of "
        f"the row's max |logit| (tol {PARITY_REL_TOL:.3e}),"
        f" {compared} greedy tokens compared, {len(diverged)} near-tie "
        "divergences")
    return dict(max_logit_diff=max_diff, max_rel=max_rel,
                tokens_compared=compared)


# --- phase 8: offline prefill / decode ----------------------------------------------

# (B, S_max, KV, rep, Dh, lengths): the OPT-6.7B decode shape with an empty,
# a one-row, a ragged and a full slot; GQA; MQA with S_max a multiple of
# neither the kernel's 32-row tile nor its 256-row split
DECODE_ATTN_SHAPES = {
    "opt-6.7b": (4, 2048, 32, 1, 128, [0, 1, 513, 2048]),
    "gqa": (3, 2048, 8, 4, 128, [0, 700, 2048]),
    "mqa": (2, 1000, 1, 8, 128, [1000, 37]),
}
OFFLINE_B, OFFLINE_PROMPT, OFFLINE_PAD, OFFLINE_STEPS = 4, 128, 2048, 32
OFFLINE_TRACE = 8
# the main path's decode attention: the OPT-6.7B cache at the middle of the
# run's decode (kv_len 128..159), timed for the kernels line
DECODE_MAIN_LEN = OFFLINE_PROMPT + OFFLINE_STEPS // 2


def _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh, dtype):
    """Unscaled queries (B, H, Dh) and caches (B, S_max, KV, Dh)."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, n_kv * rep, dh), mk(b, s_max, n_kv, dh), mk(b, s_max, n_kv,
                                                              dh)


def time_decode_attn(torch, timer, lengths):
    """Kernel, plain version and SDPA (on the same cache, a length mask)
    at the OPT-6.7B decode shape, bf16, with ``lengths``; and the bound:
    the live K/V rows, q and the state at 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (decode_attention_state,
                                                 decode_attention_state_plain,
                                                 group_decode_queries)

    b, s_max, n_kv, rep, dh, _ = DECODE_ATTN_SHAPES["opt-6.7b"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                               torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    t_kernel = timer(lambda: decode_attention_state(q, kc, vc, lens))
    t_plain = timer(lambda: decode_attention_state_plain(q, kc, vc, lens),
                    reps=3)
    qs = group_decode_queries(q, n_kv, kc.dtype)          # (B, KV, 1, Dh)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, scale=1.0))
    live = sum(min(x, s_max) for x in lengths)
    nbytes = (live * n_kv * dh * 2 * 2 + qs.numel() * 2
              + b * n_kv * rep * (dh + 2) * 4 + b * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * rep * dh * n_kv * live)
    log(f"  decode_attn B={b} S_max={s_max} KV={n_kv} rep={rep} Dh={dh} "
        f"lengths={lengths}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} "
        f"ms, SDPA {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


def phase_decode_attn(torch, timer):
    """8(a): the decode kernel against both plain versions (the bounds at
    kernel_errors in kernels/decode_attn.py), bf16 and f32 caches."""
    from repro_torch.kernels.decode_attn import (decode_attention_state,
                                                 group_decode_queries,
                                                 kernel_errors)

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = 0.0
    for name, (b, s_max, n_kv, rep, dh, lengths) in \
            DECODE_ATTN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                                       dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            acc, m, l = decode_attention_state(q, kc, vc, lens)
            torch.cuda.synchronize()
            errs = kernel_errors(group_decode_queries(q, n_kv, dtype), kc, vc,
                                 lens, acc, m, l)
            max_abs = errs.pop("max_abs_err")
            if not all(v <= 1 for v in errs.values()):
                raise AssertionError(f"decode attention {name} {dtype}: "
                                     f"error / bound {errs}")
            worst = max(worst, max_abs)
            log(f"  decode_attn {name:8s} {str(dtype)[6:]:8s} error / bound: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; max abs err {max_abs:.3e}")
    time_decode_attn(torch, timer, DECODE_ATTN_SHAPES["opt-6.7b"][5])
    main = time_decode_attn(torch, timer, [DECODE_MAIN_LEN] * OFFLINE_B)
    return dict(max_abs_err=worst, **main)


def phase_offline(torch):
    """8(b): seeded OPT-6.7B at full width and depth, deployed at RBER 1e-4;
    prefill 4 prompts of 128 tokens into a cache padded to 2048, then 32
    greedy decode steps, the launch counters zeroed just before and read
    just after; then 8 decode steps timed and 8 traced."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import deploy
    from repro_torch.kernels import decode_attn, ecdp, paged_attn, paged_ecdp
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import dense

    cfg = OPT_6_7B
    t0 = time.perf_counter()
    params = dense.init(cfg, torch.Generator(device="cuda").manual_seed(10),
                        device="cuda")
    params, _ = deploy(params, rber=1e-4, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    log(f"  init + deploy {cfg.name}: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    prefill = make_prefill_step(cfg, pad_to=OFFLINE_PAD)
    decode = make_decode_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (OFFLINE_B, OFFLINE_PROMPT))).int().cuda()
    counters = (decode_attn.decode_attention_state, ecdp.ecdp_matmul,
                paged_attn.paged_attn, paged_ecdp.paged_ecdp_matmul)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    out = [last.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(OFFLINE_STEPS):
        last, cache = decode(params, cache, {"token": out[-1],
                                             "kv_len": OFFLINE_PROMPT + i})
        out.append(last.argmax(-1))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = {"decode_attn": counters[0].launches,
                "ecdp": counters[1].launches,
                "paged_attn": counters[2].launches,
                "paged_ecdp": counters[3].launches}
    peak = torch.cuda.max_memory_allocated()
    per_pass = cfg.n_layers * 2 + 1                # FFN w_up, w_down; lm_head
    assert launches == {"decode_attn": cfg.n_layers * OFFLINE_STEPS,
                        "ecdp": per_pass * (1 + OFFLINE_STEPS),
                        "paged_attn": 0, "paged_ecdp": 0}, launches
    assert tuple(cache["k"].shape) == (cfg.n_layers, OFFLINE_B, OFFLINE_PAD,
                                       cfg.n_kv_heads, cfg.head_dim)
    assert bool(torch.isfinite(last).all())
    gen_toks = torch.stack(out, 1).cpu()
    assert bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all())
    ms_step = t_decode / OFFLINE_STEPS * 1e3
    log(f"  prefill {OFFLINE_B} x {OFFLINE_PROMPT} tokens (cache padded to "
        f"{OFFLINE_PAD}): {t_prefill * 1e3:.1f} ms; {OFFLINE_STEPS} greedy "
        f"decode steps: {ms_step:.2f} ms/step, "
        f"{OFFLINE_B * OFFLINE_STEPS / t_decode:.1f} generated tokens/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    log(f"  first prompt's tokens: {gen_toks[0, :12].tolist()}")
    kv = [OFFLINE_PROMPT + OFFLINE_STEPS]

    def step():
        nonlocal last, cache
        last, cache = decode(params, cache, {"token": last.argmax(-1),
                                             "kv_len": kv[0]})
        kv[0] += 1
    prof = trace_steps(torch, step, OFFLINE_TRACE)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, prefill_ms=t_prefill * 1e3,
                ms_per_step=ms_step, peak_bytes=peak, profile=prof)


def phase_offline_parity(torch):
    """8(c): OPT-6.7B width cut to 2 layers on the card and on the CPU:
    byte-identical deploy; prefill logits and 8 decode steps' logits (both
    fed the CPU's greedy tokens) within 2^-6 of each row's largest logit,
    greedy tokens equal wherever the top-2 margin exceeds twice that; on
    the card, teacher-forced decode_step logits against forward over the
    whole sequence within the same bound."""
    import numpy as np

    from repro_torch.configs import OPT_6_7B
    from repro_torch.core.tiering import FlashWeight, _walk, deploy
    from repro_torch.models import dense
    from repro_torch.serving.engine import _map_tree

    cfg = dataclasses.replace(OPT_6_7B, n_layers=2, name="opt-6.7b-2l")
    b, s, pad, n_dec = 2, 16, 64, 8
    t0 = time.perf_counter()
    raw = dense.init(cfg, torch.Generator().manual_seed(11), device="cpu")
    p_cpu, _ = deploy(raw, rber=1e-4, seed=2)
    p_gpu, _ = deploy(_map_tree(lambda t: t.cuda(), raw), rber=1e-4, seed=2)
    del raw
    n_flash = 0
    for (_, g), (_, c) in zip(_walk(p_gpu), _walk(p_cpu)):
        if isinstance(g, FlashWeight):
            n_flash += 1
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, s))).int()
    max_rel, compared = 0.0, 0

    def compare(lg_cpu, lg_gpu, what):
        nonlocal max_rel, compared
        lg_gpu = lg_gpu.cpu()
        row_max = lg_cpu.abs().amax(-1)
        rel = float(((lg_cpu - lg_gpu).abs().amax(-1) / row_max).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"{what}: logits differ by {rel:.3e} of the"
                                 " row's largest")
        max_rel = max(max_rel, rel)
        top2 = torch.topk(lg_cpu, 2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * PARITY_REL_TOL * row_max
        assert torch.equal(lg_cpu.argmax(-1)[sure], lg_gpu.argmax(-1)[sure]), \
            what
        compared += int(sure.sum())

    lg_c, c_cpu = dense.prefill(cfg, p_cpu, {"tokens": toks}, pad_to=pad)
    lg_g, c_gpu = dense.prefill(cfg, p_gpu, {"tokens": toks.cuda()},
                                pad_to=pad)
    compare(lg_c, lg_g, "prefill")
    seq, dec_gpu = [toks], [lg_g]
    for i in range(n_dec):
        tok = lg_c.argmax(-1).int()
        seq.append(tok[:, None])
        lg_c, c_cpu = dense.decode_step(cfg, p_cpu, c_cpu,
                                        {"token": tok, "kv_len": s + i})
        lg_g, c_gpu = dense.decode_step(cfg, p_gpu, c_gpu,
                                        {"token": tok.cuda(), "kv_len": s + i})
        compare(lg_c, lg_g, f"decode step {i}")
        dec_gpu.append(lg_g)
    # teacher-forced decode against forward over the whole sequence, card
    full = dense.forward(cfg, p_gpu, torch.cat(seq, 1).cuda())
    fwd_rel = 0.0
    for i, lg in enumerate(dec_gpu):
        want = full[:, s - 1 + i]
        rel = float(((lg - want).abs().amax(-1) / want.abs().amax(-1)).max())
        if rel > PARITY_REL_TOL:
            raise AssertionError(f"decode step {i} vs forward: {rel:.3e} of "
                                 "the row's largest logit")
        fwd_rel = max(fwd_rel, rel)
    log(f"  {cfg.name} (cut: 2 of 32 layers; widths as OPT-6.7B), {b} x {s}"
        f" prompt, {n_dec} decode steps, {time.perf_counter() - t0:.1f} s: "
        f"{n_flash} flash weights byte-identical; card vs CPU max |logit "
        f"diff| {max_rel:.3e} of the row's max (tol {PARITY_REL_TOL:.3e}), "
        f"{compared} greedy tokens compared; decode vs forward on the card "
        f"{fwd_rel:.3e}")
    return dict(max_rel=max_rel, fwd_rel=fwd_rel, tokens_compared=compared)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    mma_res = {n: mma_resources(build, n) for n in ("ecdp", "paged_ecdp")}
    pa_inst = paged_resources(build)
    for r in pa_inst:
        log(f"  paged_attn {r['kernel']} "
            + (f"Dh={r['dh']} k16_tiles={r['k16_tiles']}: "
               if r["kernel"] == "split" else ": ")
            + f"{r['registers']} registers, {r['smem']} B smem, spills "
              f"{r['spill_stores']}/{r['spill_loads']} B")
    if len(pa_inst) != 9 or any(r["spill_stores"] or r["spill_loads"]
                                for r in pa_inst):
        raise AssertionError(f"paged_attn instances in the build log: "
                             f"{pa_inst} (want 8 split + merge, no spills)")
    for n, rows in mma_res.items():
        if len(rows) != 6:
            raise AssertionError(f"{n}: {len(rows)} tensor-core instances "
                                 "in the build log, want 6")
        for r in rows:
            log(f"  {n} ecdp_mma_kernel m_tile={r['m_tile']} wide="
                f"{int(r['wide'])}: {r['registers']} registers, {r['smem']} B "
                f"smem, spills {r['spill_stores']}/{r['spill_loads']} B")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)

    log("phase 2: ECDP kernel vs plain")
    ecdp_res = phase_ecdp(torch, timer)
    log("phase 3: paged attention kernel vs plain")
    pa_res = phase_paged(torch, timer)
    torch.cuda.empty_cache()
    log("phase 4: serving OPT-6.7B")
    serve = phase_serving(torch, timer)
    del timer
    log("phase 5: engine parity, card vs CPU")
    phase_parity(torch)
    log("phase 6: paged ECDP kernel vs plain and vs ECDP")
    timer = Timer(torch)
    paged_res = phase_paged_ecdp(torch, timer)
    del timer
    torch.cuda.empty_cache()
    log("phase 7: streamed serving OPT-6.7B")
    streamed = phase_streamed(torch)
    log("phase 8: offline prefill / decode OPT-6.7B")
    timer = Timer(torch)
    da_res = phase_decode_attn(torch, timer)
    del timer
    torch.cuda.empty_cache()
    offline = phase_offline(torch)
    phase_offline_parity(torch)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    step = serve["ecdp_step"]
    kernels = [
        {"name": "ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ecdp.cu",
         "replaces": "src/repro/kernels/ecdp.py:72",
         "launches": serve["launches"]["ecdp"],
         "max_abs_err": ecdp_res["max_abs_err"], "ms": step["ms"],
         "kernel_ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": step["library_ms"],
         "at": "one OPT-6.7B serving step's 129 calls back to back: 32 x "
               "(wq, wo, w_up, w_down) at M=64, lm_head at M=4",
         "per_launch": ecdp_res["per_launch"],
         "bf16_instances": mma_res["ecdp"]},
        {"name": "paged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:94",
         "launches": serve["launches"]["paged_attn"],
         "max_abs_err": max(r["max_abs_err"] for r in pa_res.values()),
         "ms": pa_res["ragged"]["ms"], "kernel_ms": pa_res["ragged"]["ms"],
         "plain_ms": pa_res["ragged"]["plain_ms"],
         "bound_ms": pa_res["ragged"]["bound_ms"],
         "bound_by": pa_res["ragged"]["bound_by"],
         "library_ms": pa_res["ragged"]["library_ms"],
         "at": "B=4 KV=32 TR=16 Dh=128 block 16, ctx %s" % PAGED_CTX,
         "at_serving_ctx": pa_res["serving"],
         "instances": pa_inst},
        {"name": "paged_ecdp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_ecdp.cu",
         "replaces": "src/repro/kernels/paged_ffn.py:156",
         "launches": streamed["launches"]["paged_ecdp"],
         "max_abs_err": paged_res["max_abs_err"],
         "ms": paged_res["layer"]["ms"], "kernel_ms": paged_res["layer"]["ms"],
         "plain_ms": paged_res["layer"]["plain_ms"],
         "bound_ms": paged_res["layer"]["bound_ms"],
         "bound_by": paged_res["layer"]["bound_by"],
         "library_ms": paged_res["layer"]["library_ms"],
         "at": "one OPT-6.7B layer's 4 paged calls back to back at M=64: "
               "wq, wo (4096x4096), w_up (4096x16384), w_down (16384x4096)",
         "per_launch": paged_res["per_launch"],
         "bf16_instances": mma_res["paged_ecdp"]},
        {"name": "decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:79",
         "launches": offline["launches"]["decode_attn"],
         "max_abs_err": da_res["max_abs_err"], "ms": da_res["ms"],
         "kernel_ms": da_res["ms"], "plain_ms": da_res["plain_ms"],
         "bound_ms": da_res["bound_ms"], "bound_by": da_res["bound_by"],
         "library_ms": da_res["library_ms"],
         "at": f"B={OFFLINE_B} S_max={OFFLINE_PAD} KV=32 rep=1 Dh=128 bf16, "
               f"lengths {DECODE_MAIN_LEN} (one layer of an OPT-6.7B decode "
               "step)"},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
