"""The benchmark's command: one run of one cell on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit), and the same
checks as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA card, without the cell's chips, or when a JAX
module was loaded in this process by the time the window closed. Every
build and kernel cache lives under the checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"),
                         0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["REPRO_SERVE_ECC"] = "inline"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    cell, _, _ = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3

    import repro_torch

    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"the program under test is this checkout's src/repro_torch, "
              f"not {repro_torch.__file__}", file=sys.stderr)
        return 3

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, log=log)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
