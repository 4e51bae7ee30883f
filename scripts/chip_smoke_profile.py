#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s wall time goes: runs the named phases of the
smoke run, each alone and under cProfile, and prints each phase's wall
seconds and its functions by cumulative time. For cutting the script's
time: the ``phase_seconds`` line of a whole run says which phase to look
at, this says what inside it costs (the profiler's post-processing, a
model drawn by the CPU's generator, the CPU's side of a card-vs-CPU
check).

Needs one card (it builds the kernels first):

    python3 scripts/chip_smoke_profile.py [--top N] PHASE [PHASE ...]

PHASE is one of the phases that run without an earlier phase's result:
2 3 4 5 6 7 8 9 10 11 12 14 15 17. cProfile's own cost makes every phase
slower than in the smoke run; compare the shares, not the seconds.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def phases(torch, c):
    """Each standalone phase as chip_smoke's main() calls it."""
    def timed(fn):
        return lambda: fn(torch, c.Timer(torch))

    def offline():
        c.phase_decode_attn(torch, c.Timer(torch))
        c.phase_offline(torch)
        c.phase_offline_parity(torch)

    def faults():
        c.phase_chaos(torch)
        c.phase_prefix(torch)
    return {"2": timed(c.phase_ecdp), "3": timed(c.phase_paged),
            "4": timed(c.phase_serving), "5": lambda: c.phase_parity(torch),
            "6": timed(c.phase_paged_ecdp),
            "7": lambda: c.phase_streamed(torch), "8": offline, "9": faults,
            "10": lambda: c.phase_spec(torch),
            "11": lambda: c.phase_granite(torch),
            "12": lambda: c.phase_moe(torch),
            "14": lambda: c.phase_families(torch),
            "15": lambda: c.phase_train(torch),
            "17": lambda: c.phase_sharded(torch)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+")
    ap.add_argument("--top", type=int, default=45,
                    help="functions printed a phase, by cumulative time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    table = phases(torch, c)
    unknown = [p for p in args.phases if p not in table]
    if unknown:
        ap.error(f"not a standalone phase: {unknown}; one of {list(table)}")
    for name in args.phases:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        table[name]()
        prof.disable()
        print(f"=== phase {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(
            args.top)
        print(out.getvalue(), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
