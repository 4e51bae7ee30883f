"""NAND constants of the page store, from the analytic model
(``simulator/hw.py``) as the reference's store takes them from
``repro/simulator/hw.py``, and the plane split of a sharded store (the
port of ``repro/core/scheduler.shard_planes``).

A page is 16 KiB (one 128x128 int8 weight tile); a plane reads one page in
5.12 us; the NVLLM configuration of the paper (Table 3, ``NVLLM_8C``) has
32 planes. Planes read in parallel, so the array time of a batch of reads
is set by the busiest plane (``nand_read_seconds``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.simulator.hw import (NVLLM_8C, PAGE_BYTES, PLANE_READ_S,
                                      nand_read_seconds)

N_PLANES = NVLLM_8C.n_planes

__all__ = ["N_PLANES", "PAGE_BYTES", "PLANE_READ_S", "nand_read_seconds",
           "shard_planes"]


def shard_planes(n_planes: int, n_shards: int) -> np.ndarray:
    """Round-robin plane-group assignment of a sharded store: plane ``p``
    belongs to shard ``p % n_shards``. Returns the (n_shards, n_planes //
    n_shards) plane ids; raises when ``n_shards`` does not divide
    ``n_planes``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_planes % n_shards:
        raise ValueError(
            f"n_shards={n_shards} must divide the plane-group count "
            f"(n_planes={n_planes}) for the per-shard plane dispatch")
    return np.arange(n_planes).reshape(-1, n_shards).T
