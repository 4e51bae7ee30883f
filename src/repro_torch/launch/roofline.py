"""Roofline terms of a counted step — the port of
``repro/launch/roofline.py`` (``model_flops``, ``roofline_terms``), for
one NVIDIA H100:

    compute term    = flops / PEAK_FLOPS
    memory term     = bytes / HBM_BW
    collective term = wire_bytes / LINK_BW

The flops, bytes and wire bytes come from ``launch/cost.count`` over the
step's ops, per chip (``launch/dryrun.py``). On one card no op crosses a
link: the wire dict is empty and ``collective_s`` is 0.

The collective term's bandwidth is the port's assumption of how a mesh
sits on H100 nodes: eight GPUs to an HGX node, joined by NVLink 4
(``LINK_BW``), one 400 Gb/s NDR ConnectX-7 NIC a GPU between nodes
(``NIC_BW``), and the ranks laid out row-major over the mesh's axes, eight
consecutive ranks a node. A group that stays inside a node runs at
``LINK_BW``; one that spans nodes at ``NIC_BW``. On the (16, 16) and (2,
16, 16) meshes a "model" group of 16 spans two nodes and every "data" or
"pod" group spans 16 or 2, so every collective there runs at ``NIC_BW``
(``collective_bw``).

Not ported: ``bytes_of_type``, ``collective_bytes`` and their HLO regexes.
They parse XLA's compiled HLO text (instruction types, while-loop trip
counts, collective ops), which a PyTorch program does not produce; the
port counts each op as it is dispatched instead (``launch/cost.py``).
"""
from __future__ import annotations

from typing import Any

# --- hardware constants: NVIDIA H100 80GB HBM3 (SXM), 700 W ------------------
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s each way, NVLink 4 (18 links)
NIC_BW = 50e9              # bytes/s, 400 Gb/s NDR, one ConnectX-7 a GPU
GPUS_PER_NODE = 8          # an HGX H100 node


def collective_bw(mesh_shape: tuple | None) -> float:
    """The bandwidth of a mesh's collectives: ``LINK_BW`` when every axis's
    group stays inside one node (ranks row-major over the axes, eight
    consecutive ranks a node; one card: None), else ``NIC_BW``."""
    stride = 1
    for size in reversed(tuple(mesh_shape or ())):
        span = size * stride               # the ranks one group reaches
        if size > 1 and (span > GPUS_PER_NODE or GPUS_PER_NODE % span):
            return NIC_BW
        stride = span
    return LINK_BW


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6*N*D train, 2*N*D fwd-only (N = active)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_terms(flops: float, hbm_bytes: float, wire_by_op: dict,
                   n_chips: int, useful_flops: float,
                   link_bw: float = LINK_BW) -> dict[str, Any]:
    """All inputs are per card; ``link_bw`` the collectives' bandwidth
    (``collective_bw(mesh_shape)``)."""
    wire_bytes = sum(wire_by_op.values())
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = wire_bytes / link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total_flops = flops * n_chips
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm_bytes,
        "wire_bytes_per_chip": wire_bytes,
        "collectives_by_op": wire_by_op,
        "model_flops": useful_flops,
        "useful_flops_ratio": (useful_flops / total_flops
                               if total_flops else 0.0),
        # roofline fraction: useful work rate vs peak, if the step ran at the
        # pace of its dominant term (perfect overlap of the other two).
        "roofline_fraction": (useful_flops / n_chips / PEAK_FLOPS / bound
                              if bound > 0 else 0.0),
        "step_time_lower_bound_s": bound,
    }
