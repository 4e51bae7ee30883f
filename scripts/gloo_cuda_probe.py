#!/usr/bin/env python3
"""Which ``gloo`` collectives run on CUDA tensors of one card: several
ranks on one card is the only way to run a multi-rank training mesh on a
one-card machine (NCCL takes one rank a card), and DTensor's
redistributions use the functional collectives
(``torch.distributed._functional_collectives``). Each collective runs in
its own 2-rank ``gloo`` world (``torch.multiprocessing``, a ``FileStore``
in a temporary directory) on ``cuda:0``, so one that crashes its ranks
does not stop the others; each prints ``ok`` or ``FAILED`` with the
exception (a crashed rank: the signal).

Needs one card:

    python3 scripts/gloo_cuda_probe.py

Prints the card's name, its power limit and the torch version first; the
last line is a JSON object, collective -> "ok" or the failure.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

OPS = ("barrier", "all_reduce", "broadcast", "all_gather",
       "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "funcol_all_reduce", "funcol_all_gather", "funcol_reduce_scatter")


def _wait(t):
    return t.wait() if hasattr(t, "wait") else t


def _rank(r: int, world: int, store: str, op: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=r, world_size=world)
    x = torch.arange(8, dtype=torch.float32, device="cuda") + r
    group = list(range(world))
    if op == "barrier":
        dist.barrier()
    elif op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif op == "all_gather_into_tensor":
        dist.all_gather_into_tensor(
            torch.empty(8 * world, device="cuda"), x)
    elif op == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(8 // world, device="cuda"), x)
    elif op == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif op == "funcol_all_reduce":
        _wait(fc.all_reduce(x, "sum", group))
    elif op == "funcol_all_gather":
        _wait(fc.all_gather_tensor(x, 0, group))
    elif op == "funcol_reduce_scatter":
        _wait(fc.reduce_scatter_tensor(x, "sum", 0, group))
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    out = {}
    for op in OPS:
        try:
            mp.spawn(_rank, args=(2, os.path.join(tempfile.mkdtemp(), "s"),
                                  op), nprocs=2, join=True)
            out[op] = "ok"
        except Exception as e:           # the rank's failure, recorded
            out[op] = f"{type(e).__name__}: " + str(e).strip().splitlines()[-1]
        print(op, out[op], flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
