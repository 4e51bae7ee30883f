"""The tensor-parallel serving mesh — the port of ``repro/launch/mesh.py``'s
``make_model_mesh``.

A mesh here is a list of devices on the "model" axis, driven by one
process, as the reference's ``shard_map`` is: shard ``s`` of the weight
page pool and of every layer's FFN lives on ``devices[s]``, and the DRAM
tier, attention, the lm_head and the sampling stay on ``devices[0]``.

``make_model_mesh(n_shards, device)`` takes ``n_shards`` distinct devices
of ``device``'s type and raises when the host has fewer, as the reference
does when its device count does not divide. An explicit ``devices`` list
may name one device more than once: the counterpart of the reference's
forced virtual devices (the CPU tests pass ``[cpu] * S``, a one-card run
``[cuda:0] * S``).
"""
from __future__ import annotations

import dataclasses

import torch

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """``devices[s]`` holds shard ``s``; ``devices[0]`` is the first device,
    where everything that is not sharded lives."""
    devices: tuple

    axis_names = (MODEL_AXIS,)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def _device_count(kind: str) -> int:
    if kind == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1                             # torch has one CPU device


def make_model_mesh(n_shards: int, device="cuda",
                    devices=None) -> ModelMesh:
    """The "model" mesh of ``n_shards`` shards: the first ``n_shards``
    devices of ``device``'s type, or the explicit ``devices`` (which may
    repeat a device)."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != n_shards:
            raise ValueError(f"a mesh of n_shards={n_shards} needs "
                             f"{n_shards} devices, got {len(devs)}")
        return ModelMesh(devs)
    kind = torch.device(device).type
    n = _device_count(kind)
    if n < n_shards:
        raise ValueError(
            f"n_shards={n_shards} needs {n_shards} distinct {kind} devices; "
            f"{n} visible (pass an explicit device list, which may repeat "
            "a device, to run the shards on fewer)")
    if kind == "cpu":
        return ModelMesh((torch.device("cpu"),))
    return ModelMesh(tuple(torch.device(kind, i) for i in range(n_shards)))


def data_axis_names(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
