"""Reading the card's profile: device time by kernel group and by op,
and the busy seconds.

``GROUPS`` is a frozen copy of the smoke script's kernel grouping (first
match wins, by substrings of the lower-cased kernel name);
``KERNEL_GROUPS`` names the group whose device time each roofline reads.
"""
from __future__ import annotations

GROUPS = (
    ("grouped ecdp kernel", ("grouped_ecdp_",)),
    ("ecdp kernel", ("ecdp_",)),
    ("paged attention kernel", ("paged_attn_",)),
    ("decode attention kernel", ("decode_attn_",)),
    ("GEMM (DRAM projections)", ("gemm", "cutlass", "sm90_", "ampere_",
                                 "cublas", "nvjet")),
    ("sort / top-k / scan (MoE routing)", ("sort", "topk", "radix",
                                           "scan", "bitonic")),
    ("elementwise / reduction / copy", ("elementwise", "reduce", "copy",
                                        "index", "cat", "gather", "scatter",
                                        "fill", "softmax", "norm")),
)

# the roofline's kernel -> the profile group its device time is read from
KERNEL_GROUPS = {"ecdp": "ecdp kernel",
                 "grouped_ecdp": "grouped ecdp kernel",
                 "paged_attn": "paged attention kernel"}


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


class Segment:
    """One profiled stretch of steps (device activity only): its device
    ops as (name, start_us, end_us), and its wall seconds."""

    def __init__(self, prof, wall_s: float, steps: int):
        import torch

        self.wall_s, self.steps = wall_s, steps
        self.device = sorted(
            (e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the ops' intervals)."""
        busy, end = 0.0, None
        for _, a, b in sorted(self.device, key=lambda r: r[1]):
            if end is None or a >= end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e6

    def group_s(self) -> dict:
        out: dict = {}
        for name, a, b in self.device:
            g = group(name)
            out[g] = out.get(g, 0.0) + (b - a) / 1e6
        return out

    def op_s(self) -> dict:
        out: dict = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out
