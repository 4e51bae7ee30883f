#!/usr/bin/env python3
"""Where the paged-attention kernel spends its time, by knock-out.

Builds copies of ``src/repro_torch/kernels/csrc/paged_attn.cu`` with one
part taken out or changed and times each (CUDA events, L2 flushed before
each call: chip_smoke's ``Timer``) at phase 3's shape of ``chip_smoke.py``
(B=4, KV=32, TR=16, Dh=128, block 16, table width 128) and its two context
sets:

  base        the kernel as it is (8 pool blocks a range)
  bps4, bps16 the same build with 4 or 16 pool blocks a range
  no_loads    the cp.async copies dropped (the ring keeps stale bytes)
  no_l2_hint  the copies without their L2 evict-first hint
  no_mma      the products dropped (QK^T and PV)
  fast_exp    expf as __expf (the approximate exponential)
  no_merge    the merge launch dropped (the split kernel alone)
  empty_split the split kernel returns at once (the merge and the floor)
  stages2/4   a ring of 2 or 4 chunks a warp instead of 3

A knocked-out variant computes garbage: only its time is read. Needs one
card and nvcc:

    python3 scripts/paged_attn_variants.py

The base build is timed once more after an L2 flush that leaves clean
lines (``base_clean_l2``: the timer's own flush writes, so a call that
misses pays the write-back of the dirty lines), and profiled under both
flushes with torch.profiler: the device time of each of its two kernels
(split, merge) per call; SDPA on the K/V gathered through the tables is
timed under both flushes beside it. Last, the timer's floor (the time it gives one
tiny kernel). Prints one
line per context set and, last, the times as one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = {
    "base": [],
    "no_loads": [(
        '  asm volatile(\n'
        '      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, '
        '%3;\\n"\n'
        '      ::"r"(d), "l"(src), "r"(ok ? 16 : 0), "l"(policy)\n'
        '      : "memory");', "")],
    "no_l2_hint": [(
        '"cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, '
        '%3;\\n"',
        '"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"')],
    "no_mma": [(
        '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
        '{%0, %1, %2, %3};\\n"\n'
        '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), '
        '"r"(b1));',
        "  c[0] += __uint_as_float(a[0] ^ a[3] ^ b0 ^ b1);")],
    "fast_exp": [("expf(sc[nt][hf][e] - m_safe[e >> 1])",
                  "__expf(sc[nt][hf][e] - m_safe[e >> 1])")],
    "no_merge": [("  paged_attn_merge_kernel<<<",
                  "  if (0) paged_attn_merge_kernel<<<")],
    "empty_split": [("  if (h >= KV) return;", "  if (h >= 0) return;")],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
}
# runs of the base build with another split plan: (label, pool blocks a range)
PLANS = [("bps4", 4), ("bps16", 16)]


def build_variants(build, pa, tmp: Path) -> dict:
    src0 = (build.CSRC / "paged_attn.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = src0
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the text to alter has moved")
            src = src.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "paged_attn.cu").write_text(src)
        procs[name] = subprocess.Popen(
            build.nvcc_command(d / "paged_attn.cu", d / "paged_attn.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        libs[name] = pa._bind(ctypes.CDLL(str(tmp / name / "paged_attn.so")))
    return libs


def profile(torch, timer, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler),
    the L2 cache flushed before each call as ``timer`` does."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timer.flush_l2()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if "paged_attn" in evt.key and us > 0:
            name = "split" if "split" in evt.key else "merge"
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("paged_attn_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import PAGED_CTX, PAGED_SERVING_CTX, PAGED_SHAPE, Timer
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attn as pa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    class CleanTimer(Timer):
        def flush_l2(self):           # read, not write: clean lines in L2
            self.flush.view(torch.int32).max()

    timer = Timer(torch)
    clean = CleanTimer(torch)
    b, n_kv, tr, dh, bs, max_blocks = PAGED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_blocks = 1 + b * max_blocks

    def bf(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    q = (bf(b, n_kv, tr, dh).float() * dh ** -0.5).to(torch.bfloat16)
    k_pool, v_pool = bf(n_blocks, bs, n_kv, dh), bf(n_blocks, bs, n_kv, dh)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, pa, Path(tmp))
        for label, ctx in (("ragged", PAGED_CTX),
                           ("serving", PAGED_SERVING_CTX)):
            perm = (torch.randperm(n_blocks - 1, generator=gen,
                                   device="cuda") + 1).int()
            tables = torch.zeros((b, max_blocks), dtype=torch.int32,
                                 device="cuda")
            pi = 0
            for i, c in enumerate(ctx):
                nb = -(-c // bs)
                tables[i, :nb] = perm[pi:pi + nb]
                pi += nb
            lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
            args = (q, k_pool, v_pool, tables, lens)
            row = {name: timer(lambda: pa._launch(lib, *args))
                   for name, lib in libs.items()}
            for name, bps in PLANS:     # the wrapper's plan, swapped
                pa._BLOCKS_PER_SPLIT, keep = bps, pa._BLOCKS_PER_SPLIT
                try:
                    row[name] = timer(lambda: pa._launch(libs["base"],
                                                         *args))
                finally:
                    pa._BLOCKS_PER_SPLIT = keep
            row["base_clean_l2"] = clean(lambda: pa._launch(libs["base"],
                                                            *args))
            # the yardstick under both flushes: SDPA on the gathered K/V
            s_pad = max_blocks * bs
            kg, vg = (pool[tables.long()].reshape(b, s_pad, n_kv, dh)
                      .transpose(1, 2).contiguous()
                      for pool in (k_pool, v_pool))
            mask = (torch.arange(s_pad, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            for key, t in (("sdpa", timer), ("sdpa_clean_l2", clean)):
                row[key] = t(lambda: F.scaled_dot_product_attention(
                    q, kg, vg, attn_mask=mask, scale=1.0))
            del kg, vg
            kernels = {f"{k}{'_clean_l2' if t is clean else ''}": v
                       for t in (timer, clean) for k, v in profile(
                           torch, t, lambda: pa._launch(libs["base"], *args)
                       ).items()}
            results[label] = dict(ctx=ctx, ms=row, base_kernels_ms=kernels)
            print(f"{label:8s} ctx={ctx} " + " | ".join(
                f"{key} {t:.4f}" for key, t in row.items()), flush=True)
            print(f"{label:8s} base, device ms per call: " + " | ".join(
                f"{key} {t:.4f}" for key, t in kernels.items()), flush=True)
    tiny = torch.zeros(1, device="cuda")
    results["floor_ms"] = timer(lambda: tiny.add_(1.0))
    print(f"timer floor (one 1-element kernel): {results['floor_ms']:.4f} ms")
    print(json.dumps({"device": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
