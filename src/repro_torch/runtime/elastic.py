"""Elastic re-meshing: resume on a different device count / topology — the
port of ``repro/runtime/elastic.py``.

The recovery path after losing a fault domain: build a mesh over the ranks
that remain, re-derive the specs (the rules in ``launch/sharding.py`` are
mesh-shape-agnostic thanks to the divisibility guard), and put the
checkpointed state onto the new mesh. Checkpoints hold full host arrays
(``checkpoint/manager.py``), so any old-mesh -> new-mesh move is exact.

``plan_mesh`` picks the (data, model) grid over ``n_devices`` ranks, the
model axis as close to ``prefer_model`` as a divisor allows; scale-up goes
through the same path. A mesh is a ``DeviceMesh`` over the process group's
first data x model ranks (``launch.mesh.init_distributed`` makes a world
of one when there is no group).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import init_distributed


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_grid(n_devices: int, prefer_model: int = 16) -> tuple[int, int]:
    """The (data, model) grid of ``plan_mesh``: the model axis the divisor
    of ``n_devices`` nearest ``prefer_model`` (the larger on a tie; model
    width changes collective cost much faster than data width, so it is
    kept stable across re-meshes)."""
    model = sorted(_divisors(n_devices),
                   key=lambda m: (abs(m - prefer_model), -m))[0]
    return n_devices // model, model


def plan_mesh(n_devices: int, prefer_model: int = 16, device="cuda"):
    """A ("data", "model") ``DeviceMesh`` of ``plan_grid``'s shape over the
    world's first ``n_devices`` ranks (every rank of the world calls it)."""
    from torch.distributed.device_mesh import DeviceMesh
    data, model = plan_grid(n_devices, prefer_model)
    kind = torch.device(device).type
    init_distributed(kind)
    world = dist.get_world_size()
    if n_devices > world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks; the world has {world}")
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    params_specs: Any
    step: int


def remesh_restore(manager, template, n_devices: int,
                   prefer_model: int = 16, fsdp: bool = False,
                   device="cuda"):
    """Restore the latest checkpoint onto a fresh mesh over ``n_devices``.

    Returns (state, ElasticState). ``template`` is a tree of tensors (any
    device, meta included) with the checkpoint's structure; the specs are
    ``param_specs`` of it, as the reference's."""
    mesh = plan_mesh(n_devices, prefer_model, device)
    pspecs = sh.param_specs(template, mesh, fsdp=fsdp)
    state, extras = manager.restore(template, placements=sh.named(pspecs, mesh),
                                    mesh=mesh)
    return state, ElasticState(mesh=mesh, params_specs=pspecs,
                               step=int(extras.get("step", 0)))
