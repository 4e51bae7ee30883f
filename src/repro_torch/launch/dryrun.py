"""Dry-run of every (arch x shape) cell on one card — the port of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun [--arch A|all] [--shape S|all]
        [--mesh single] [--smoke] [--out DIR]

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

``--mesh`` takes ``single``: the reference's 512-device meshes and FSDP
(``launch/mesh.py``, ``launch/sharding.py``) come with tensor parallelism
(ROADMAP §A.4); ``fsdp`` in ``TRAIN_KNOBS`` is ignored until then.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, applicable,
                                 batch_specs, cache_specs, get_config)
from repro_torch.configs.shapes import SMOKE_OVERRIDES
from repro_torch.launch import cost as cost_mod
from repro_torch.launch import roofline as rl

# Per-arch training memory knobs (DESIGN.md §5): bf16 moments and gradient
# accumulation for the capacity-stress cases; ``fsdp`` waits for §A.4.
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


def build_cell(arch: str, shape_name: str, smoke: bool = False,
               cfg=None, shape: ShapeSpec | None = None,
               knobs: dict | None = None, on: str = "meta", built=None):
    """(step_fn, args, ctx) of one cell, its inputs meta tensors (``on=
    "fake"``: fake CPU tensors), nothing allocated; run the step inside
    ``ctx``. ``cfg``, ``shape`` and ``knobs`` override the registry's
    config, the named shape and ``TRAIN_KNOBS[arch]`` (a library caller's
    cell; the command line takes neither); ``built`` is ``build_params``'s
    output, made here when not given."""
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import AdamW

    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    mod = family_module(cfg.family)
    params, ctx = built or build_params(cfg, shape.kind != "train", on)
    with ctx:
        batch = {k: _like(v) for k, v in batch_specs(cfg, shape).items()}
        if shape.kind == "train":
            opt = AdamW(moment_dtype=knobs.get("moment_dtype", "float32"))
            step = make_train_step(
                cfg, opt, n_micro=knobs.get("n_micro", 1),
                accum_dtype=getattr(torch, knobs.get("accum_dtype",
                                                     "float32")))
            return step, (params, opt.init(params), batch), ctx
        if shape.kind == "prefill":
            return make_prefill_step(cfg), (params, batch), ctx
        cache = {k: _like(v) for k, v in cache_specs(cfg, shape).items()}

    def step(params, cache, batch):
        pos = batch["kv_len"].reshape(1).long()
        return mod.decode_body(cfg, params, cache, batch["token"], pos), cache

    return step, (params, cache, batch), ctx


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
               on: str = "meta", deployed: dict | None = None) -> dict:
    """Count one cell (at its points, extrapolated): the cost, the
    arguments' bytes, the peak live bytes and how they were counted. A
    training step's microbatches are one loop body counted once and charged
    ``n_micro`` times (``cost.repeats``). ``on="fake"`` counts on the fake
    tensors themselves. ``deployed`` ({(config, on): ``build_params``'
    output}) keeps an arch's serving params for its next serving cell."""
    from repro_torch.launch import steps

    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    serving = shape.kind != "train"
    axes = _axes(cfg, train=not serving)
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
                                     knobs=knobs, built=built)
        del built
        t1 = time.perf_counter()
        with ctx:
            got = cost_mod.count(step, *args,
                                 loops=((steps, "accumulate_grads"),))
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

    wire_ops = {k for _, g in samples for k in g.cost.wire}
    total = cost_mod.Cost(
        flops=extrapolate(lambda g: g.cost.flops),
        bytes=extrapolate(lambda g: g.cost.bytes),
        wire={k: extrapolate(lambda g: g.cost.wire.get(k, 0.0))
              for k in wire_ops},
        n_collectives=extrapolate(lambda g: g.cost.n_collectives))
    names = {k for _, g in samples for k in g.boundaries}
    kinds = {k for _, g in samples for k in g.flops_by_kind}
    return dict(
        cost=total,
        argument_bytes=round(extrapolate(lambda g: g.argument_bytes)),
        peak_live_bytes=round(extrapolate(lambda g: g.peak_live_bytes)),
        n_ops=round(extrapolate(lambda g: g.n_ops)),
        boundaries={k: round(extrapolate(lambda g: g.boundaries.get(k, 0)))
                    for k in sorted(names)},
        flops_by_kind={k: extrapolate(lambda g: g.flops_by_kind.get(k, 0.0))
                       for k in sorted(kinds)},
        axes=[dict(axis=n, points=[lo, hi], target=t)
              for n, lo, hi, t in axes],
        build_s=build_s, count_s=count_s)


def run_cell(arch: str, shape_name: str, smoke: bool = False, cfg=None,
             shape: ShapeSpec | None = None, knobs: dict | None = None,
             deployed: dict | None = None) -> dict:
    """One cell's JSON record; a failure is recorded, not raised.
    ``deployed``: ``count_cell``'s."""
    cfg, shape, knobs = _cell(arch, shape_name, smoke, cfg, shape, knobs)
    cell = {"arch": arch, "shape": shape.name, "mesh": MESH,
            "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {**cell, "status": "skipped", "reason": reason}
    try:
        got = count_cell(arch, shape_name, cfg=cfg, shape=shape, knobs=knobs,
                         deployed=deployed)
        c = got["cost"]
        terms = rl.roofline_terms(c.flops, c.bytes, c.wire, 1,
                                  rl.model_flops(cfg, shape))
        return {
            **cell, "status": "ok",
            "build_s": round(got["build_s"], 3),
            "count_s": round(got["count_s"], 3),
            "memory": {"argument_size_in_bytes": got["argument_bytes"],
                       "peak_live_bytes": got["peak_live_bytes"]},
            "fits_card": got["peak_live_bytes"] <= H100_80GB_HBM3_BYTES,
            "n_collectives": c.n_collectives,
            "roofline": terms,
            "counted": {"axes": got["axes"], "n_ops": got["n_ops"],
                        "plain_version_calls": got["boundaries"],
                        "flops_by_kind": got["flops_by_kind"]},
        }
    except Exception as e:  # a failure here is a bug in the system
        return {**cell, "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS) + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity, not the deliverable)")
    ap.add_argument("--out", default="build/dryrun_torch")
    args = ap.parse_args()
    if args.mesh != "single":
        raise SystemExit(f"--mesh {args.mesh}: the port's dry-run covers one "
                         "card; the multi-device meshes come with tensor "
                         "parallelism (ROADMAP §A.4)")

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    t_all = time.perf_counter()
    deployed: dict = {}
    for arch in archs:
        for shape in shapes:
            res = run_cell(arch, shape, smoke=args.smoke, deployed=deployed)
            tag = f"{arch}_{shape}_{res['mesh']}" + (
                "_smoke" if args.smoke else "")
            (outdir / f"{tag}.json").write_text(json.dumps(res, indent=1))
            rf = res.get("roofline", {})
            mem = res.get("memory", {})
            print(f"[{res['status']:7s}] {tag:52s} "
                  f"count={res.get('build_s', 0) + res.get('count_s', 0):6.2f}s"
                  f" peak={mem.get('peak_live_bytes', 0) / 2**30:9.2f}GiB "
                  f"dom={rf.get('dominant', '-'):12s} "
                  f"bound={rf.get('step_time_lower_bound_s', 0):.4g}s"
                  + (f"  ERR {res.get('error', '')[:120]}"
                     if res["status"] == "error" else ""),
                  flush=True)
            n_fail += res["status"] == "error"
    print(f"{len(archs) * len(shapes)} cells in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
