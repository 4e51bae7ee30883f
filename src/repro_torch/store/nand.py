"""NAND constants of the page store — the port's copy of the parts of
``repro/simulator/hw.py`` and ``repro/core/scheduler.py`` the store uses.

A page is 16 KiB (one 128x128 int8 weight tile); a plane reads one page in
5.12 us; the NVLLM configuration of the paper (Table 3, ``NVLLM_8C``) has
32 planes. Planes read in parallel, so the array time of a batch of reads
is set by the busiest plane.
"""
from __future__ import annotations

import numpy as np

PAGE_BYTES = 16 * 1024
PLANE_READ_S = 5.12e-6
N_PLANES = 32                    # NVLLM_8C.n_planes


def nand_read_seconds(plane_reads) -> float:
    """Analytical NAND time of a per-plane page-read histogram: the
    slowest plane's reads times the plane read latency."""
    reads = list(plane_reads)
    return (max(reads) * PLANE_READ_S) if reads else 0.0


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
