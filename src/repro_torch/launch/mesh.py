"""The meshes — the port of ``repro/launch/mesh.py``.

Training meshes are ``torch.distributed`` ``DeviceMesh``es, one process
per device, over the default process group (``init_distributed`` joins
``torchrun``'s or makes a world of one): ``make_host_mesh(model_axis)`` is
(world / m, m) ("data", "model") over every rank; ``make_production_mesh``
the reference's (16, 16) ("data", "model") or, ``multi_pod``, (2, 16, 16)
("pod", "data", "model"), and it raises on a world of another size. "pod"
is an outer data axis.

The tensor-parallel serving mesh (``make_model_mesh``, ``ModelMesh``) is
a list of devices on the "model" axis, driven by one
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
import os
import tempfile

import torch
import torch.distributed as dist

MODEL_AXIS = "model"
PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(kind: str) -> str:
    return "nccl" if kind == "cuda" else "gloo"


def _world_size() -> int:
    """The process group's world size; outside one, ``torchrun``'s
    ``WORLD_SIZE`` (1 when there is none)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def under_torchrun() -> bool:
    """Whether ``torchrun`` (or a launcher like it) started this process:
    its rank and rendezvous address are in the environment."""
    return "RANK" in os.environ and "MASTER_ADDR" in os.environ


def init_distributed(device="cuda"):
    """Join the default process group if there is none: ``torchrun``'s
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` in the environment), else a
    world of one over a ``FileStore`` in a fresh temporary directory (no
    network). ``nccl`` for the card (each rank on ``cuda:LOCAL_RANK``),
    ``gloo`` for the CPU."""
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if under_torchrun():
        dist.init_process_group(_backend(kind))
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group(_backend(kind), store=store, rank=0,
                            world_size=1)


def _device_mesh(kind: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_host_mesh(model_axis: int | None = None, device="cuda"):
    """The ("data", "model") mesh over every rank of the process group
    (joined or made by ``init_distributed``): (world / m, m), m =
    ``model_axis`` or 1."""
    kind = torch.device(device).type
    init_distributed(kind)
    n = dist.get_world_size()
    m = model_axis or 1
    if n % m:
        raise ValueError(f"model_axis={m} does not divide the world of {n}")
    return _device_mesh(kind, (n // m, m), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``, one rank per
    device. Raises ``ValueError`` on a world of another size (before any
    process group is made)."""
    shape, names = PRODUCTION_SHAPE[multi_pod]
    need = 1
    for s in shape:
        need *= s
    have = _world_size()
    if have != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs a world "
            f"of {need} ranks, one per device; this one has {have} (run "
            f"under torchrun --nnodes ... --nproc-per-node ... so that "
            f"WORLD_SIZE={need})")
    kind = torch.device(device).type
    init_distributed(kind)
    return _device_mesh(kind, shape, names)


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
    """The data axes of a ``ModelMesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))
