#!/usr/bin/env python3
"""The readings behind ``tests/test_torch_dist_train.py``'s bounds, on the
CPU: how far a train step over a ("data", "model") mesh parts from the
same step on one device, in each package, and the two packages' mesh
steps from each other.

Each run is ``STEPS`` steps of granite-8b and qwen3-moe-30b-a3b smoke from
``PRNGKey(0)``'s init (the port's loaded through ``interop``), AdamW under
``warmup_cosine(PEAK_LR, 2, 10)``, the batches of
``tests/torch_dist_helpers.batch_np`` at a seed. The reference runs in a
subprocess with 16 forced devices: its step jitted with ``in_shardings``
and ``out_shardings`` on (2, 2), (2, 1) and (1, 1) meshes under
``--xla_allow_excess_precision=false``, and on (2, 2) under XLA's default
flags (``--eager``: also op by op, about 2 min more). The port runs on 4
and 2 ``gloo`` ranks (``torch.multiprocessing``, a ``FileStore``) and in
one process (one MoE token group, and two forced).

Printed: for each pair of runs, the losses' largest gap at the first step
and after it, and (at the first batch seed) the first moments' largest
|difference| as a share of their leaf's largest, with that leaf. With
``--seeds A B`` qwen3-moe's losses are read over batch seeds A..B-1 (the
reference's (2, 2) against its (2, 1), and the port's (2, 2) against the
reference's): how often routes flip after an update.

    PYTHONPATH=src python3 scripts/mesh_parity_readings.py [--seeds 10 40] [--eager]

Needs no card (JAX and the port on the CPU); about 2 minutes at one seed.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_dist_helpers as H  # noqa: E402

_REF = r'''
import json, pickle, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
from torch_dist_helpers import ARCHS, STEPS, PEAK_LR, batch_np
from repro.configs import get_config
from repro.launch import sharding as sh
from repro.launch.steps import make_train_step
from repro.models import family_module
from repro.optim.adamw import AdamW
from repro.optim.schedule import warmup_cosine

out, mode = Path(sys.argv[1]), sys.argv[3]
shape = tuple(int(x) for x in sys.argv[4].split("x"))
seeds = range(int(sys.argv[5]), int(sys.argv[6]))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                         .reshape(shape), ("data", "model"))
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    opt = AdamW(lr=warmup_cosine(PEAK_LR, 2, 10))
    p0 = family_module(cfg.family).init(cfg, jax.random.PRNGKey(0))
    with open(out / f"{arch}.init.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, p0), f)
    s0 = opt.init(p0)
    ps = sh.param_specs(p0, mesh)
    np_, no = sh.named(ps, mesh), sh.named(sh.opt_state_specs(
        s0, ps, mesh, zero1=True), mesh)
    step = make_train_step(cfg, opt, grad_specs=ps)
    with mesh:
        jitted = jax.jit(step, in_shardings=(np_, no, None),
                         out_shardings=(np_, no, None))
    res = {}
    for seed in (seeds if arch != "granite-8b" else seeds[:1]):
        params, state = jax.device_put(p0, np_), jax.device_put(s0, no)
        losses, m = [], None
        for i in range(STEPS):
            b = {k: jnp.asarray(v)
                 for k, v in batch_np(cfg.vocab_size, i, seed).items()}
            b = jax.device_put(b, sh.named(sh.batch_specs(b, mesh), mesh))
            with mesh:
                if mode == "eager":
                    with jax.disable_jit():
                        params, state, met = step(params, state, b)
                else:
                    params, state, met = jitted(params, state, b)
            losses.append(float(met["loss"]))
            if i == 0 and seed == seeds[0]:
                m = {sh._path_str(p): np.asarray(x.astype(jnp.float32))
                     for p, x in jax.tree_util.tree_leaves_with_path(state.m)}
        res[seed] = {"losses": losses, "m": m}
    with open(out / f"{arch}.{sys.argv[7]}.pkl", "wb") as f:
        pickle.dump(res, f)
'''


def reference(d: Path, tag: str, shape: str, seeds, mode="jit",
              precise=True) -> None:
    flags = "--xla_force_host_platform_device_count=16"
    if precise:
        flags += " --xla_allow_excess_precision=false"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    run = subprocess.run(
        [sys.executable, "-c", _REF, str(d), str(ROOT / "tests"), mode,
         shape, str(seeds[0]), str(seeds[-1] + 1), tag], env=env,
        capture_output=True, text=True, timeout=1800)
    if run.returncode:
        raise RuntimeError(run.stderr[-3000:])


def _port_rank(rank, world, store, out, shape, seeds, tag):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = port_runs(Path(out), tuple(shape), seeds)
        if rank == 0:
            for arch, r in res.items():
                with open(Path(out) / f"{arch}.{tag}.pkl", "wb") as f:
                    pickle.dump(r, f)
    finally:
        dist.destroy_process_group()


def port_runs(d: Path, shape, seeds, groups=None) -> dict:
    """{arch: {seed: {"losses", "m"}}}: over the process group's host
    mesh of ``shape`` when ``shape`` is given, else in this process (the
    MoE's token groups forced to ``groups`` when given)."""
    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW, warmup_cosine

    mesh = make_host_mesh(shape[1], device="cpu") if shape else None
    saved = sh.data_group_count
    if groups is not None:
        sh.data_group_count = lambda n: groups
    out = {}
    try:
        for arch in H.ARCHS:
            cfg = get_config(arch, smoke=True)
            with open(d / f"{arch}.init.pkl", "rb") as f:
                init = pickle.load(f)
            res = {}
            for seed in (seeds if arch != "granite-8b" else seeds[:1]):
                params = interop.params_from_numpy(init, device="cpu")
                opt = AdamW(lr=warmup_cosine(H.PEAK_LR, 2, 10))
                state = opt.init(params)
                specs = None
                if mesh is not None:
                    specs = sh.param_specs(params, mesh)
                    params = sh.distribute(params, sh.named(specs, mesh),
                                           mesh)
                    state = sh.distribute(state, sh.named(
                        sh.opt_state_specs(state, specs, mesh, zero1=True),
                        mesh), mesh)
                step = steps.make_train_step(cfg, opt, grad_specs=specs)
                losses, m = [], None
                for i in range(H.STEPS):
                    b = {k: torch.from_numpy(v) for k, v in
                         H.batch_np(cfg.vocab_size, i, seed).items()}
                    if mesh is not None:
                        b = sh.distribute(b, sh.named(sh.batch_specs(
                            b, mesh), mesh), mesh)
                        with sh.use_mesh(mesh):
                            params, state, met = step(params, state, b)
                    else:
                        params, state, met = step(params, state, b)
                    losses.append(float(met["loss"]))
                    if i == 0 and seed == seeds[0]:
                        m = {p: (x.full_tensor() if sh.is_dtensor(x)
                                 else x).float().clone().numpy()
                             for p, x in sh.leaves_with_path(state.m)}
                res[seed] = {"losses": losses, "m": m}
            out[arch] = res
    finally:
        sh.data_group_count = saved
    return out


def port_mesh(d: Path, tag: str, shape, seeds) -> None:
    import torch.multiprocessing as mp
    world = shape[0] * shape[1]
    mp.start_processes(_port_rank, args=(
        world, str(d / f"store-{tag}"), str(d), list(shape), seeds, tag),
        nprocs=world, join=True, start_method="spawn")


def _load(d: Path, arch: str, tag: str) -> dict:
    with open(d / f"{arch}.{tag}.pkl", "rb") as f:
        return pickle.load(f)


def compare(a: dict, b: dict, seed: int) -> dict:
    la, lb = np.array(a[seed]["losses"]), np.array(b[seed]["losses"])
    gap = np.abs(la - lb)
    out = {"first_loss_gap": float(gap[0]), "later_loss_gap": float(
        gap[1:].max())}
    if a[seed]["m"] is not None and b[seed]["m"] is not None:
        worst = max((float(np.abs(a[seed]["m"][k] - b[seed]["m"][k]).max()
                           / max(np.abs(b[seed]["m"][k]).max(), 1e-30)), k)
                    for k in b[seed]["m"])
        out["moment_rel"], out["moment_leaf"] = worst
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs=2, default=(10, 11))
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    seeds = list(range(*args.seeds))
    d = Path(tempfile.mkdtemp())
    reference(d, "ref22", "2x2", seeds)
    reference(d, "ref21", "2x1", seeds)
    reference(d, "ref11", "1x1", seeds[:1])
    reference(d, "ref22_default", "2x2", seeds[:1], precise=False)
    if args.eager:
        reference(d, "ref22_eager", "2x2", seeds[:1], mode="eager")
    port_mesh(d, "port22", (2, 2), seeds)
    port_mesh(d, "port21", (2, 1), seeds[:1])
    for arch, r in port_runs(d, None, seeds[:1]).items():
        with open(d / f"{arch}.port1.pkl", "wb") as f:
            pickle.dump(r, f)
    for arch, r in port_runs(d, None, seeds[:1], groups=2).items():
        with open(d / f"{arch}.port1g2.pkl", "wb") as f:
            pickle.dump(r, f)
    pairs = [("port22", "ref22"), ("port22", "port1"), ("ref22", "ref11"),
             ("port21", "port1g2"), ("ref22_default", "ref22"),
             ("port1", "ref22"), ("port1g2", "ref22")]
    if args.eager:
        pairs.append(("ref22", "ref22_eager"))
    report = {}
    for arch in H.ARCHS:
        for a, b in pairs:
            if arch == "granite-8b" and b == "port1g2":
                continue
            got = compare(_load(d, arch, a), _load(d, arch, b), seeds[0])
            report[f"{arch} {a} vs {b}"] = got
            print(f"{arch:20s} {a:14s} vs {b:8s} {json.dumps(got)}",
                  flush=True)
    q = "qwen3-moe-30b-a3b"
    for a, b in (("port22", "ref22"), ("ref22", "ref21")):
        ra, rb = _load(d, q, a), _load(d, q, b)
        later = [compare(ra, rb, s)["later_loss_gap"] for s in seeds]
        first = [compare(ra, rb, s)["first_loss_gap"] for s in seeds]
        report[f"{q} {a} vs {b} over seeds"] = dict(
            seeds=args.seeds, first_max=max(first), later_max=max(later),
            within_1e3=sum(max(f, x) <= 1e-3 for f, x in zip(first, later)))
        print(f"{q} {a} vs {b} over seeds {args.seeds[0]}..{args.seeds[1] - 1}:"
              f" first-loss gap up to {max(first):.3e}, later up to "
              f"{max(later):.3e}; all three within 1e-3 on "
              f"{report[f'{q} {a} vs {b} over seeds']['within_1e3']} of "
              f"{len(seeds)}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
