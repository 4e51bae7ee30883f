#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s profiled training step (phase 15(a)) finds
its window markers in the trace: runs 15(a) (``train_full``) with its
profiled step taken ``--runs`` times, and prints one JSON line a run: the
attention windows, how many steps ``train_profile`` had to profile (2
when a trace lost a marker kernel's record), the kernels and
milliseconds of each group. ``--lose-one`` drops one closing marker's
record from the first trace, so that run shows the second profiled step.

Needs one card:

    python3 scripts/train_profile_markers.py [--runs K] [--lose-one]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--lose-one", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.profiler as tp

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    profile_once, plain_profile = c.train_profile, tp.profile
    lose = [args.lose_one]

    class Lossy(plain_profile):
        def events(self):
            ev = super().events()
            if not lose[0]:
                return ev
            lose[0] = False
            for j, e in enumerate(ev):
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and "bitwiseor" in e.name.lower().replace("_", "")):
                    return type(ev)(list(ev[:j]) + list(ev[j + 1:]))
            raise AssertionError("no closing marker in the trace")

    def profiled_runs(torch_, run):
        out = None
        tp.profile = Lossy
        try:
            for i in range(args.runs):
                t0 = time.perf_counter()
                out = profile_once(torch_, run)
                print(json.dumps(dict(
                    run=i, attention_windows=out["attention_windows"],
                    profiled_steps=out["profiled_steps"],
                    groups_count=out["groups_count"],
                    groups_ms=out["groups_ms"],
                    seconds=time.perf_counter() - t0)), flush=True)
        finally:
            tp.profile = plain_profile
        return out

    c.train_profile = profiled_runs
    c.train_full(torch)
    print(json.dumps({"runs": args.runs, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
