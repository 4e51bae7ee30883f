"""Dry-run of every (arch x shape) cell on the reference's production
meshes and on one card — the port of ``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun [--arch A|all] [--shape S|all]
        [--mesh single|multi|both|card] [--smoke] [--jobs N] [--out DIR]

Each cell is built and counted without allocating anything, without
arithmetic and without CUDA, as the reference's ``jax.eval_shape`` and
lower. The family's ``init`` runs under a ``FakeTensorMode`` (each (K, N)
matrix is drawn on the generator's device: there, a fake CPU tensor);
the tree is then lowered to meta tensors of the same shapes, dtypes and
storage sharing (``lower``), on which ``core/tiering.deploy`` runs at RBER 0
for the serving cells, then ``make_prefill_step``, the decode body
(``decode_body``: ``decode_step``'s host check reads ``kv_len``, which has
no value here) or ``make_train_step`` with the arch's ``TRAIN_KNOBS``,
counted by ``launch/cost.count``. The tensors are not CUDA tensors, so the
kernels' plain versions are the ones reached, and ``cost`` counts them at
their boundaries. Meta kernels give the counts the fake tensors give
(``count_cell(on="fake")``; the tests hold the two equal) in about a third
of the time: the fake mode's bookkeeping costs 0.15 to 1.7 ms an op.

The reference's scans are while loops, which XLA's HLO counts once and
multiplies by the trip count. The port's layer and microbatch loops are
Python loops: counting llama3-405b's 126 layers x 16 microbatches op by op
would dispatch some 2.6 M ops. So a training step's microbatches are one
loop body, counted once and charged ``n_micro`` times (``cost.repeats``),
and a cell's cost, linear in its depth (layers; RG-LRU superblocks; the
encoder-decoder's two stacks), is counted at two depths and extrapolated
multilinearly to its own: flops, bytes, arguments and peak live bytes
alike. A config no deeper than the second point is counted as it is
(``--smoke``).

Each cell's JSON keeps the reference's keys where they mean the same
thing (``status``, ``reason``, ``n_collectives``, ``roofline`` with every
key of ``roofline_terms``) and records ``build_s``, ``count_s``,
``memory`` (``argument_size_in_bytes``: params, optimizer state, cache and
batch; ``peak_live_bytes``), ``fits_card`` (the peak against the H100's
80 GB) and ``counted`` (the depths and the plain-version calls).

``--mesh`` has the reference's meanings: ``single`` is the (16, 16)
("data", "model") mesh, ``multi`` the (2, 16, 16) ("pod", "data",
"model") one, ``both`` the two (the default); ``card`` is one H100 (cells
named ``1xH100``). A mesh cell (named ``16x16`` / ``2x16x16``, as the
reference's) counts one chip's share of the step, as the reference's
``hlo_cost`` counts one device's SPMD program: one process stands for
every rank over a ``fake`` process group of 256 or 512 ranks (``FakeStore``;
nothing is sent), made for the cell and destroyed after it, under
``launch/mesh.make_production_mesh`` on "cpu". Every leaf is a DTensor
whose local shard is a meta tensor (``place``: ``DTensor.from_local``,
nothing scattered): the params by ``sharding.param_specs`` (training with
``fsdp`` from ``TRAIN_KNOBS``; serving without, as the reference), the
optimizer's moments by ZeRO-1 ``opt_state_specs``, the batch and the
caches by their specs; ``n_micro`` is halved until each microbatch divides
the data axes (the reference's rule). The step runs under
``sharding.use_mesh`` (training with ``grad_specs``), and ``cost.count``
charges each chip's local ops, its kernel boundaries on its shards and
every collective DTensor issues into ``Cost.wire``. The record's
``memory`` is one chip's, ``fits_card`` one chip's peak against the
H100, and ``roofline_terms`` takes the mesh's size and the bandwidth of
its links (``roofline.collective_bw``). ``mesh_shape`` (a library caller's,
e.g. (2, 2) or (1, 1)) replaces the production shape; under an existing
process group (a test's ranks) the cell's mesh is made over it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, applicable,
                                 batch_specs, cache_specs, get_config)
from repro_torch.configs.shapes import SMOKE_OVERRIDES
from repro_torch.launch import cost as cost_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh

# Per-arch training memory knobs (DESIGN.md §5): FSDP, bf16 moments and
# gradient accumulation for the capacity-stress cases.
TRAIN_KNOBS: dict[str, dict] = {
    "llama3-405b": dict(fsdp=True, moment_dtype="bfloat16", n_micro=16,
                        accum_dtype="bfloat16"),
    "llava-next-34b": dict(fsdp=True, moment_dtype="float32", n_micro=4),
    "qwen3-32b": dict(fsdp=True, moment_dtype="float32", n_micro=4),
    "qwen3-moe-30b-a3b": dict(fsdp=True, moment_dtype="float32", n_micro=4),
    "phi3.5-moe-42b-a6.6b": dict(fsdp=True, moment_dtype="float32", n_micro=4),
    "mistral-nemo-12b": dict(fsdp=True, n_micro=2),
    "granite-8b": dict(fsdp=True, n_micro=2),
    "recurrentgemma-9b": dict(fsdp=True, n_micro=2),
    "rwkv6-3b": dict(fsdp=True, n_micro=2),
    "seamless-m4t-medium": dict(n_micro=1),
}

SERVE_INT8 = True     # paper §4.1: all models quantized INT8 for serving

# NVIDIA H100 80GB HBM3: a cell fits one card when its peak is at most this
H100_80GB_HBM3_BYTES = 80e9
MESH = "1xH100"
# the reference's production meshes by name: multi_pod
MESHES = {"16x16": False, "2x16x16": True}
MESH_CHOICES = {"single": ["16x16"], "multi": ["2x16x16"],
                "both": ["16x16", "2x16x16"], "card": [None]}


def _like(spec: torch.Tensor) -> torch.Tensor:
    """A tensor of a meta spec's shape and dtype on the default device (the
    cell's context: meta, or a fake mode's CPU)."""
    return torch.empty(spec.shape, dtype=spec.dtype)


def _cell(arch, shape_name, smoke, cfg, shape, knobs):
    """A cell's config, shape (at the smoke sizes with ``smoke``) and
    training knobs, the overrides taking precedence."""
    cfg = cfg if cfg is not None else get_config(arch, smoke=smoke)
    shape = shape if shape is not None else SHAPES[shape_name]
    if smoke:
        s, b = SMOKE_OVERRIDES[shape.kind]
        shape = dataclasses.replace(shape, seq_len=s, global_batch=b)
    if knobs is None:
        knobs = TRAIN_KNOBS.get(arch, {}) if not smoke else {}
    return cfg, shape, knobs


def lower(tree, memo: dict | None = None):
    """A tree of fake tensors (dicts, lists, tuples, named tuples,
    ``FlashWeight``s) as meta tensors of the same shapes, strides, dtypes
    and storage sharing."""
    from repro_torch.core.tiering import FlashWeight

    memo = {} if memo is None else memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            st = tree.untyped_storage()
            base = memo.get(id(st))
            if base is None:
                base = memo[id(st)] = torch.empty(
                    (st.nbytes(),), dtype=torch.uint8,
                    device="meta").untyped_storage()
            memo[id(tree)] = torch.empty(
                (0,), dtype=tree.dtype, device="meta").set_(
                    base, tree.storage_offset(), tree.shape, tree.stride())
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {k: lower(v, memo) for k, v in tree.items()}
    if isinstance(tree, FlashWeight):
        return FlashWeight(*(lower(t, memo) for t in (tree.q, tree.parity,
                                                       tree.scale)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(lower(v, memo) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(lower(v, memo) for v in tree)
    return tree


def build_params(cfg, serving: bool, on: str = "meta"):
    """(params, the context the cell's other inputs are made in): the
    family's ``init`` under a ``FakeTensorMode``, then, with ``on="meta"``,
    lowered to meta tensors, and for a serving cell deployed at RBER 0. The
    deploy quantizes and encodes every (K, N) slice of a stack alike, so
    it runs that once per shape (``cost.loop_bodies``); the codec's lookup
    tables become tensors of the deploy's device, meta or fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import ecc, tiering
    from repro_torch.models import family_module

    # made real, once, outside the mode (a table made under it would be
    # cached fake); the fake mode lifts them
    ecc._device_tables(torch.device("cpu"))
    ctx = FakeTensorMode(allow_non_fake_inputs=True)
    with ctx:
        params = family_module(cfg.family).init(cfg, torch.Generator(),
                                                device="cpu")
    if on == "meta":
        params, ctx = lower(params), torch.device("meta")
    if serving and SERVE_INT8:
        with ctx, cost_mod.loop_bodies((tiering, "quantize_int8"),
                                       (ecc, "encode")):
            params = tiering.deploy(params)[0]
    return params, ctx


# --- the mesh cells --------------------------------------------------------------

@contextlib.contextmanager
def mesh_world(mesh: str | None = None, mesh_shape: tuple | None = None):
    """The ``DeviceMesh`` of a cell (None: one card): the reference's
    production mesh ``mesh`` ("16x16", "2x16x16"), or a ("data", "model")
    or ("pod", "data", "model") mesh of ``mesh_shape``, on "cpu". Over the
    process group if there is one (its world the mesh's size), else over a
    ``fake`` world of that size made here and destroyed at the end."""
    if mesh is None and mesh_shape is None:
        yield None
        return
    if mesh_shape is None:
        shape, names = mesh_mod.PRODUCTION_SHAPE[MESHES[mesh]]
    else:
        shape = tuple(mesh_shape)
        names = mesh_mod.PRODUCTION_SHAPE[len(shape) == 3][1]
    made = not dist.is_initialized()
    if made:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    try:
        if mesh_shape is None:
            yield mesh_mod.make_production_mesh(multi_pod=MESHES[mesh],
                                                device="cpu")
        else:
            yield mesh_mod._device_mesh("cpu", shape, names)
    finally:
        if made:
            dist.destroy_process_group()


def place(tree, specs, mesh):
    """``tree``'s meta tensors as DTensors on ``mesh`` placed by ``specs``
    (a tree of ``sharding.P``): each a meta local shard with the global
    shape, nothing scattered (``sharding.distribute`` would)."""
    def one(_, t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        pls = sh.placements(spec, mesh)
        local = list(t.shape)
        for i, p in enumerate(pls):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        return sh.from_shard(torch.empty(local, dtype=t.dtype,
                                         device="meta"), mesh, pls)
    return sh.map_with_path(one, tree, specs)


def data_extent(mesh) -> int:
    """The ranks along the data axes ("pod", "data") of ``mesh``."""
    return math.prod(mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)
                     if a in sh.DATA_AXES)


def _n_micro(knobs: dict, shape: ShapeSpec, mesh) -> int:
    """The knobs' microbatches, halved until each divides the data axes
    (the reference's rule; one card: as they are)."""
    n_micro = knobs.get("n_micro", 1)
    while (mesh is not None and n_micro > 1
           and (shape.global_batch // n_micro) % data_extent(mesh)):
        n_micro //= 2
    return n_micro


@contextlib.contextmanager
def _no_update():
    """Within: ``AdamW.apply_`` leaves everything as it is (a training
    step counted without its update)."""
    from repro_torch.optim.adamw import AdamW
    apply_ = AdamW.apply_
    AdamW.apply_ = lambda self, grads, state, params: state
    try:
        yield
    finally:
        AdamW.apply_ = apply_


def _on_mesh(step, mesh):
    """``step`` run under ``sharding.use_mesh(mesh)``."""
    def run(*args):
        with sh.use_mesh(mesh):
            return step(*args)
    return run


def build_cell(arch: str, shape_name: str, smoke: bool = False,
               cfg=None, shape: ShapeSpec | None = None,
               knobs: dict | None = None, on: str = "meta", built=None,
               mesh=None):
    """(step_fn, args, ctx) of one cell, its inputs meta tensors (``on=
    "fake"``: fake CPU tensors), nothing allocated; run the step inside
    ``ctx``. ``cfg``, ``shape`` and ``knobs`` override the registry's
    config, the named shape and ``TRAIN_KNOBS[arch]`` (a library caller's
    cell; the command line takes neither); ``built`` is ``build_params``'s
    output, made here when not given. ``mesh``: a ``DeviceMesh``
    (``mesh_world``'s) that every input is placed on (meta only)."""
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import AdamW

    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    if mesh is not None and on != "meta":
        raise ValueError("a mesh cell is counted on meta tensors")
    mod = family_module(cfg.family)
    params, ctx = built or build_params(cfg, shape.kind != "train", on)
    with ctx:
        batch = {k: _like(v) for k, v in batch_specs(cfg, shape).items()}
        if mesh is not None:
            batch = place(batch, sh.batch_specs(batch, mesh), mesh)
        if shape.kind == "train":
            opt = AdamW(moment_dtype=knobs.get("moment_dtype", "float32"))
            state = opt.init(params)
            n_micro, pspecs = _n_micro(knobs, shape, mesh), None
            if mesh is not None:
                pspecs = sh.param_specs(params, mesh,
                                        fsdp=knobs.get("fsdp", False))
                state = place(state, sh.opt_state_specs(
                    state, pspecs, mesh, zero1=True), mesh)
                params = place(params, pspecs, mesh)
            step = make_train_step(
                cfg, opt, n_micro=n_micro, grad_specs=pspecs,
                accum_dtype=getattr(torch, knobs.get("accum_dtype",
                                                     "float32")))
            args = (params, state, batch)
        elif shape.kind == "prefill":
            step, args = make_prefill_step(cfg), (params, batch)
        else:
            cache = {k: _like(v) for k, v in cache_specs(cfg, shape).items()}
            if mesh is not None:
                cache = place(cache, sh.cache_specs(cache, mesh), mesh)

            def step(params, cache, batch):
                pos = batch["kv_len"].reshape(1).long()
                return (mod.decode_body(cfg, params, cache, batch["token"],
                                        pos), cache)
            args = (params, cache, batch)
        if mesh is not None and shape.kind != "train":
            args = (place(params, sh.param_specs(params, mesh), mesh),
                    ) + args[1:]
    if mesh is not None:
        step = _on_mesh(step, mesh)
    return step, args, ctx


# --- the depths counted -------------------------------------------------------

def _axes(cfg, train: bool) -> list[tuple]:
    """(name, low, high, target) of each axis a cell's cost is linear in,
    where the config is deeper than the high point: the layers (RG-LRU: its
    (r, r, a) superblocks; the encoder-decoder: both stacks; a training
    step under sqrt-remat: its groups)."""
    if cfg.family == "encdec":
        axes = [("n_enc_layers", 1, 2, cfg.n_enc_layers),
                ("n_layers", 1, 2, cfg.n_layers)]
    elif cfg.family == "rglru":
        axes = [("superblocks", 1, 2, cfg.n_layers // 3)]
    elif (train and cfg.remat_groups > 1
          and cfg.n_layers % cfg.remat_groups == 0):
        # sqrt-remat: the cost is bilinear in the group count and the
        # group size (two levels of recompute), each counted from 2
        axes = [("remat_groups", 2, 3, cfg.remat_groups),
                ("group_size", 2, 3, cfg.n_layers // cfg.remat_groups)]
    else:
        axes = [("n_layers", 1, 2, cfg.n_layers)]
    return [a for a in axes if a[3] > a[2]]


def _sample(cfg, point: dict):
    """The config at one point of the axes."""
    cut = {}
    for name, v in point.items():
        if name == "superblocks":
            cut["n_layers"] = 3 * v + cfg.n_layers % 3
        elif name in ("remat_groups", "group_size"):
            g = point.get("remat_groups", cfg.remat_groups)
            k = point.get("group_size", cfg.n_layers // cfg.remat_groups)
            cut.update(n_layers=g * k, remat_groups=g)
        else:
            cut[name] = v
    if cut:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-cut", **cut)
    return cfg


def count_cell(arch: str, shape_name: str, smoke: bool = False, cfg=None,
               shape: ShapeSpec | None = None, knobs: dict | None = None,
               on: str = "meta", deployed: dict | None = None,
               mesh: str | None = None,
               mesh_shape: tuple | None = None) -> dict:
    """Count one cell (at its points, extrapolated): the cost, the
    arguments' bytes, the peak live bytes and how they were counted. A
    training step's microbatches are one loop body counted once and charged
    ``n_micro`` times (``cost.repeats``). ``on="fake"`` counts on the fake
    tensors themselves. ``deployed`` ({(config, on): ``build_params``'
    output}) keeps an arch's serving params for its next serving cell.
    ``mesh`` / ``mesh_shape``: one chip's share on that mesh
    (``mesh_world``), its arguments placed at the config's own depth;
    ``n_chips`` is its size."""
    with mesh_world(mesh, mesh_shape) as dm:
        got = _count_points(arch, shape_name, smoke, cfg, shape, knobs, on,
                            deployed, dm)
    got["mesh_shape"] = None if dm is None else tuple(dm.shape)
    got["n_chips"] = math.prod(got["mesh_shape"] or (1,))
    return got


def _count_points(arch, shape_name, smoke, cfg, shape, knobs, on, deployed,
                  dm) -> dict:
    from repro_torch.launch import steps

    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    serving = shape.kind != "train"
    axes = _axes(cfg, train=not serving)
    # ZeRO-1 splits a stacked leaf's moments along the layer dim only where
    # the data axes divide the depth (the specs' divisibility guard), so on
    # a mesh a step's optimizer update is not linear in depth: the samples
    # leave it out, and it is counted at the config's own depth
    apart = dm is not None and not serving and bool(axes)
    build_s = count_s = 0.0
    samples = []
    for corner in itertools.product(*[(lo, hi) for _, lo, hi, _ in axes]):
        point = {a[0]: v for a, v in zip(axes, corner)}
        c_cfg = _sample(cfg, point)
        t0 = time.perf_counter()
        built = deployed.get((c_cfg, on)) if serving and deployed else None
        if built is None:
            built = build_params(c_cfg, serving, on)
            if serving and deployed is not None:
                if not any(k.name.startswith(cfg.name) for k, _ in deployed):
                    deployed.clear()         # another arch's
                deployed[(c_cfg, on)] = built
        step, args, ctx = build_cell(arch, shape_name, cfg=c_cfg, shape=shape,
                                     knobs=knobs, built=built, mesh=dm)
        del built
        t1 = time.perf_counter()
        with ctx:
            # on a mesh, DTensor's sharding propagation and shard
            # bookkeeping run tensor ops of their own the first time an op
            # meets its shapes and placements: a first count fills those
            # caches and is dropped, so that the second sees the step's
            # own ops alone
            for _ in range(1 if dm is None else 2):
                with _no_update() if apart else contextlib.nullcontext():
                    got = cost_mod.count(
                        step, *args, loops=((steps, "accumulate_grads"),),
                        skip_fake=dm is not None)
        del step, args
        t2 = time.perf_counter()
        build_s += t1 - t0
        count_s += t2 - t1
        samples.append((point, got))

    def extrapolate(value) -> float:
        total = 0.0
        for point, got in samples:
            w = 1.0
            for name, lo, hi, target in axes:
                x = point[name]
                other = hi if x == lo else lo
                w *= (target - other) / (x - other)
            total += w * value(got)
        return total

    arguments = round(extrapolate(lambda g: g.argument_bytes))
    update = None
    if dm is not None and axes:
        # the guard reads the layer dim: a mesh cell's arguments, and a
        # training cell's update, at the config's own depth
        t0 = time.perf_counter()
        built = deployed.get((cfg, on)) if serving and deployed else None
        if built is None:
            built = build_params(cfg, serving, on)
        step, args, ctx = build_cell(arch, shape_name, cfg=cfg, shape=shape,
                                     knobs=knobs, built=built, mesh=dm)
        del built, step
        arguments = cost_mod.argument_bytes(args)
        t1 = time.perf_counter()
        if apart:
            with ctx:
                update = _count_update(args, knobs, shape, dm)
        del args
        build_s += t1 - t0
        count_s += time.perf_counter() - t1
    wire_ops = sorted({k for _, g in samples for k in g.cost.wire}
                      | set(update.cost.wire if update else ()))
    total = cost_mod.Cost(
        flops=extrapolate(lambda g: g.cost.flops),
        bytes=extrapolate(lambda g: g.cost.bytes),
        wire={k: extrapolate(lambda g: g.cost.wire.get(k, 0.0))
              for k in wire_ops},
        n_collectives=extrapolate(lambda g: g.cost.n_collectives),
        collectives={k: extrapolate(lambda g: g.cost.collectives.get(k, 0.0))
                     for k in wire_ops})
    names = {k for _, g in samples for k in g.boundaries}
    kinds = {k for _, g in samples for k in g.flops_by_kind}
    peak = round(extrapolate(lambda g: g.peak_live_bytes))
    n_ops = round(extrapolate(lambda g: g.n_ops))
    flops_by_kind = {k: extrapolate(lambda g: g.flops_by_kind.get(k, 0.0))
                     for k in sorted(kinds)}
    if update is not None:
        total.add(update.cost)
        peak = max(peak, update.peak_live_bytes)
        n_ops += update.n_ops
        for k, v in update.flops_by_kind.items():
            flops_by_kind[k] = flops_by_kind.get(k, 0.0) + v
    total.collectives = {k: round(v) for k, v in total.collectives.items()}
    return dict(
        cost=total,
        argument_bytes=arguments,
        peak_live_bytes=peak,
        n_ops=n_ops,
        boundaries={k: round(extrapolate(lambda g: g.boundaries.get(k, 0)))
                    for k in sorted(names)},
        flops_by_kind=flops_by_kind,
        axes=[dict(axis=n, points=[lo, hi], target=t)
              for n, lo, hi, t in axes],
        build_s=build_s, count_s=count_s)


def _count_update(args, knobs: dict, shape: ShapeSpec, mesh):
    """``AdamW.apply_`` of a training cell's (params, state) on ``mesh``,
    counted (twice, the first dropped, as a sample is) on zero gradients
    shaped and placed as the step's accumulators."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW

    params, state, _ = args
    opt = AdamW(moment_dtype=knobs.get("moment_dtype", "float32"))
    dtype = (None if _n_micro(knobs, shape, mesh) == 1 else
             getattr(torch, knobs.get("accum_dtype", "float32")))
    grads = steps.grads_like(params, dtype)
    for _ in range(2):
        got = cost_mod.count(_on_mesh(opt.apply_, mesh), grads, state,
                             params, skip_fake=True)
    return got


def mesh_name(mesh: str | None = None, mesh_shape: tuple | None = None
              ) -> str:
    """A cell's mesh as its record names it: "16x16", "2x16x16", the
    shape's ("2x2") or one card's ``MESH``."""
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return mesh or MESH


def run_cell(arch: str, shape_name: str, smoke: bool = False, cfg=None,
             shape: ShapeSpec | None = None, knobs: dict | None = None,
             deployed: dict | None = None, mesh: str | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's JSON record; a failure is recorded, not raised.
    ``deployed``, ``mesh``, ``mesh_shape``: ``count_cell``'s."""
    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    cell = {"arch": arch, "shape": shape.name,
            "mesh": mesh_name(mesh, mesh_shape), "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {**cell, "status": "skipped", "reason": reason}
    try:
        got = count_cell(arch, shape_name, cfg=cfg, shape=shape, knobs=knobs,
                         deployed=deployed, mesh=mesh, mesh_shape=mesh_shape)
        c = got["cost"]
        terms = rl.roofline_terms(c.flops, c.bytes, c.wire, got["n_chips"],
                                  rl.model_flops(cfg, shape),
                                  link_bw=rl.collective_bw(got["mesh_shape"]))
        return {
            **cell, "status": "ok",
            "build_s": round(got["build_s"], 3),
            "count_s": round(got["count_s"], 3),
            "memory": {"argument_size_in_bytes": got["argument_bytes"],
                       "peak_live_bytes": got["peak_live_bytes"]},
            "fits_card": got["peak_live_bytes"] <= H100_80GB_HBM3_BYTES,
            "n_collectives": c.n_collectives,
            "collectives": c.collectives,
            "roofline": terms,
            "counted": {"axes": got["axes"], "n_ops": got["n_ops"],
                        "plain_version_calls": got["boundaries"],
                        "flops_by_kind": got["flops_by_kind"]},
        }
    except Exception as e:  # a failure here is a bug in the system
        return {**cell, "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


_DEPLOYED: dict = {}      # this process's last arch's serving params


def shape_cells(cell: tuple, meshes: list, smoke: bool) -> list[dict]:
    """``run_cell``'s records of one (arch, shape) on each mesh, the
    arch's serving params deployed once in this process."""
    return [run_cell(*cell, smoke=smoke, deployed=_DEPLOYED, mesh=mesh)
            for mesh in meshes]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS) + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="both",
                    help="single: 16x16; multi: 2x16x16; both: the two; "
                         "card: one H100")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity, not the deliverable)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, an (arch, shape) at a time "
                         "(each with its own fake worlds)")
    ap.add_argument("--out", default="build/dryrun_torch")
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = MESH_CHOICES[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    t_all = time.perf_counter()
    run = functools.partial(shape_cells, meshes=meshes, smoke=args.smoke)
    cells = list(itertools.product(archs, shapes))
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            import concurrent.futures
            import multiprocessing
            pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            records = pool.map(run, cells)
        else:
            records = map(run, cells)
        for res in itertools.chain.from_iterable(records):
            tag = f"{res['arch']}_{res['shape']}_{res['mesh']}" + (
                "_smoke" if args.smoke else "")
            (outdir / f"{tag}.json").write_text(json.dumps(res, indent=1))
            rf = res.get("roofline", {})
            mem = res.get("memory", {})
            print(f"[{res['status']:7s}] {tag:52s} count="
                  f"{res.get('build_s', 0) + res.get('count_s', 0):6.2f}s"
                  f" peak={mem.get('peak_live_bytes', 0) / 2**30:9.2f}GiB"
                  f" coll={res.get('n_collectives', 0):8.0f} "
                  f"wire={rf.get('wire_bytes_per_chip', 0) / 2**30:8.2f}"
                  f"GiB dom={rf.get('dominant', '-'):12s} "
                  f"bound={rf.get('step_time_lower_bound_s', 0):.4g}s"
                  + (f"  ERR {res.get('error', '')[:120]}"
                     if res["status"] == "error" else ""),
                  flush=True)
            n_fail += res["status"] == "error"
    print(f"{len(archs) * len(shapes) * len(meshes)} cells in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
