"""Readings that set a cell's limits: for each seed, one run of the cell
(its window at the cell's own load), then the reference's and the
control's gaps over the same sample of the window's requests, the control
judged as the program is (``control_correct``), all seeds in one process.
With ``--fault`` the program runs with that fault planted
(``bench/faults.py``). One JSON line a seed on standard output and in
``build/bench_calibrate/<cell>.jsonl``.

    python3 bench/calibrate.py --workload <cell> --seconds 20 --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import run  # noqa: F401  (the command's environment: caches, ECC mode)
    from bench import faults, harness

    if args.fault:
        faults.plant(args.fault)
    out = ROOT / "build" / "bench_calibrate" / f"{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                             benchmark={"end_to_end": [], "per_layer": []},
                             log=lambda *a: print(*a, file=sys.stderr),
                             control=not args.fault)
        line = {"seed": seed, "fault": args.fault, "correct": r["correct"],
                "seconds": time.perf_counter() - t0,
                "device": r["device"],
                **{k: v["value"] for k, v in r["checks"].items()}}
        if "control" in r:
            c = r["control"]
            line.update(c["program_readings"])
            line["control_correct"] = c["correct"]
            line.update({f"control_{k}": v for k, v in c["readings"].items()})
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
