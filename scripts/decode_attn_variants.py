#!/usr/bin/env python3
"""Where the decode-attention kernel spends its time, by knock-out.

Builds copies of ``src/repro_torch/kernels/csrc/decode_attn.cu`` with one
part taken out or changed and times each (CUDA events, L2 flushed before
each call: chip_smoke's ``Timer``) at phase 8(a)'s OPT-6.7B decode shape of
``chip_smoke.py`` (B=4, S_max=2048, KV=32, rep=1, Dh=128, bf16: the
tensor-core body) and two length sets: the main path's (144 rows a slot)
and the long, ragged one ([0, 1, 513, 2048]):

  base        the kernel as it is (SPLIT_ROWS rows a range)
  split32 .. split256  the same build with ranges of 32, 64, 128, 256 rows
  no_loads    the cp.async copies dropped (the ring keeps stale bytes)
  no_l2_hint  the copies without their L2 evict-first hint
  no_mma      the products dropped (QK^T and PV)
  fast_exp    expf of p as __expf (the approximate exponential)
  no_merge    the merge launch dropped (the split kernel alone)
  empty_split the split kernel returns at once (the merge and the floor)
  stages3/4   a ring of 3 or 4 units a warp (base: 2)
  merge_vec4  the merge with one thread per 4 output elements (base: 1)
  merge_u32   the merge issuing 32 ranges' loads together (base: 16)

A knocked-out variant computes garbage: only its time is read. Needs one
card and nvcc:

    python3 scripts/decode_attn_variants.py

The base build is timed once more after an L2 flush that leaves clean
lines (``base_clean_l2``: the timer's own flush writes, so a call that
misses pays the write-back of the dirty lines), and profiled under both
flushes with torch.profiler: the device time of each of its two kernels
(split, merge) per call. SDPA on the same cache (a length mask) is timed
under both flushes beside it. Last, the timer's floor (the time it gives
one tiny kernel). Prints one line per length set and, last, the times as
one JSON object.
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
    "no_merge": [("  decode_attn_merge_kernel<<<",
                  "  if (0) decode_attn_merge_kernel<<<")],
    "empty_split": [("  if (h >= KV) return;", "  if (h >= 0) return;")],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "stages4": [("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "merge_vec4": [("constexpr int MERGE_VEC = 1;",
                    "constexpr int MERGE_VEC = 4;")],
    "merge_u32": [("constexpr int MERGE_U = 16;",
                   "constexpr int MERGE_U = 32;")],
}
SPLITS = (32, 64, 128, 256)      # rows a range, run on the base build
LENGTHS = {"main": None, "long": [0, 1, 513, 2048]}   # None: chip_smoke's


def build_variants(build, da, tmp: Path) -> dict:
    src0 = (build.CSRC / "decode_attn.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = src0
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the text to alter has moved")
            src = src.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "decode_attn.cu").write_text(src)
        procs[name] = subprocess.Popen(
            build.nvcc_command(d / "decode_attn.cu", d / "decode_attn.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        libs[name] = da._bind(ctypes.CDLL(str(tmp / name / "decode_attn.so")))
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
        if "decode_attn" in evt.key and us > 0:
            name = "merge" if "merge" in evt.key else "split"
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_attn_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import (DECODE_ATTN_SHAPES, DECODE_MAIN_LEN, OFFLINE_B,
                            Timer, _decode_inputs)
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as da

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    class CleanTimer(Timer):
        def flush_l2(self):           # read, not write: clean lines in L2
            self.flush.view(torch.int32).max()

    timer = Timer(torch)
    clean = CleanTimer(torch)
    b, s_max, n_kv, rep, dh, _ = DECODE_ATTN_SHAPES["opt-6.7b"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, kc, vc = _decode_inputs(torch, gen, b, s_max, n_kv, rep, dh,
                               torch.bfloat16)
    qg = da.group_decode_queries(q, n_kv, kc.dtype)
    assert da.uses_mma(qg, kc, vc)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    results = {"split_rows": da.SPLIT_ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, da, Path(tmp))
        for label, lengths in LENGTHS.items():
            lengths = lengths or [DECODE_MAIN_LEN] * OFFLINE_B
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            args = (qg, kc, vc, lens)
            row = {name: timer(lambda: da._launch(lib, *args))
                   for name, lib in libs.items()}
            keep = da.SPLIT_ROWS
            try:
                for split in SPLITS:     # the wrapper's range, swapped
                    da.SPLIT_ROWS = split
                    row[f"split{split}"] = timer(
                        lambda: da._launch(libs["base"], *args))
            finally:
                da.SPLIT_ROWS = keep
            row["base_clean_l2"] = clean(lambda: da._launch(libs["base"],
                                                            *args))
            mask = (torch.arange(s_max, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            for key, t in (("sdpa", timer), ("sdpa_clean_l2", clean)):
                row[key] = t(lambda: F.scaled_dot_product_attention(
                    qg, kt, vt, attn_mask=mask, scale=1.0))
            kernels = {f"{k}{'_clean_l2' if t is clean else ''}": v
                       for t in (timer, clean) for k, v in profile(
                           torch, t, lambda: da._launch(libs["base"], *args)
                       ).items()}
            results[label] = dict(lengths=lengths, ms=row,
                                  base_kernels_ms=kernels)
            print(f"{label:5s} lengths={lengths} " + " | ".join(
                f"{key} {t:.4f}" for key, t in row.items()), flush=True)
            print(f"{label:5s} base, device ms per call: " + " | ".join(
                f"{key} {t:.4f}" for key, t in kernels.items()), flush=True)
    tiny = torch.zeros(1, device="cuda")
    results["floor_ms"] = timer(lambda: tiny.add_(1.0))
    print(f"timer floor (one 1-element kernel): {results['floor_ms']:.4f} ms")
    print(json.dumps({"device": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
