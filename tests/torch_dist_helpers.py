"""Shared machinery for ``tests/test_torch_dist_train.py`` and
``tests/test_torch_dryrun_mesh.py`` (not a test file): ``spawn`` runs a case on N ``gloo`` ranks of a CPU process group
(``torch.multiprocessing``, a ``FileStore`` under the test's tmp dir, no
ports), with a deadline; the rank cases below write what they found into
``.npz`` / ``.pkl`` files for the test to hold against the reference;
``REFERENCE`` is the reference's side, run in a subprocess with forced
virtual CPU devices. The rank cases import only torch and the port (the
children import this module by name, not the test module)."""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("granite-8b", "qwen3-moe-30b-a3b")
STEPS = 3
BATCH, SEQ = 4, 16
PEAK_LR = 1e-3


def batch_np(vocab: int, i: int, seed: int = 10) -> dict:
    """Step ``i``'s numpy batch: 4 rows of 16 tokens and their labels."""
    rng = np.random.default_rng(seed + i)
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rank_main(rank: int, world: int, store: str, case: str, out: str,
               args: dict):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        CASES[case](rank, Path(out), **args)
    finally:
        dist.destroy_process_group()


def spawn(case: str, out: Path, world: int = 4, timeout: float = 240,
          **args) -> None:
    """Run rank case ``case`` on ``world`` gloo ranks; fails (and ends the
    ranks) past ``timeout`` seconds or when a rank fails."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(out / f"store-{case}"), case, str(out),
                          args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank case {case!r} past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


# --- rank cases ------------------------------------------------------------------

def case_steps(rank: int, out: Path, mesh_shape=(2, 2)):
    """Each arch's ``STEPS`` train steps over a ("data", "model") mesh from
    the JAX init's params (``<arch>.init.pkl``): the losses, and after the
    first step every param and first moment whole, into ``<arch>.npz``
    (rank 0)."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW, warmup_cosine

    mesh = make_host_mesh(mesh_shape[1], device="cpu")
    assert tuple(mesh.shape) == tuple(mesh_shape)
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        with open(out / f"{arch}.init.pkl", "rb") as f:
            params = interop.params_from_numpy(pickle.load(f), device="cpu")
        opt = AdamW(lr=warmup_cosine(PEAK_LR, 2, 10))
        state = opt.init(params)
        pspecs = sh.param_specs(params, mesh)
        params = sh.distribute(params, sh.named(pspecs, mesh), mesh)
        state = sh.distribute(state, sh.named(sh.opt_state_specs(
            state, pspecs, mesh, zero1=True), mesh), mesh)
        step = steps.make_train_step(cfg, opt, grad_specs=pspecs)
        dump, losses, groups = {}, [], []
        for i in range(STEPS):
            b = {k: torch.from_numpy(v)
                 for k, v in batch_np(cfg.vocab_size, i).items()}
            b = sh.distribute(b, sh.named(sh.batch_specs(b, mesh), mesh),
                              mesh)
            with sh.use_mesh(mesh):
                groups.append(sh.data_group_count(BATCH * SEQ))
                params, state, metrics = step(params, state, b)
            losses.append(float(metrics["loss"]))
            if i == 0:
                for pre, tree in (("p/", params), ("m/", state.m)):
                    for path, x in sh.leaves_with_path(tree):
                        dump[pre + path] = x.full_tensor().float().clone()\
                            .numpy()
        if rank == 0:
            np.savez(out / f"{arch}.npz", losses=np.array(losses),
                     groups=np.array(groups), **dump)


def case_compress(rank: int, out: Path):
    """``compressed_psum`` over the data group of a (2, 2) mesh: a rank's
    grads and errors drawn from seed 100 + its data index d; 20 steps of
    error feedback. The "model" rank 0 of each d writes
    ``compress-<d>.pkl``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.grad_compress import (compressed_psum,
                                                 init_error_feedback)

    mesh = make_host_mesh(2, device="cpu")
    group = mesh.get_group("data")
    d = mesh.get_local_rank("data")
    rng = np.random.default_rng(100 + d)
    g = {"a": torch.from_numpy(rng.standard_normal((8, 16)).astype(
        np.float32)), "b": {"c": torch.from_numpy(
            rng.standard_normal(33).astype(np.float32) * 3)}}
    e = {"a": torch.from_numpy(rng.standard_normal((8, 16)).astype(
        np.float32) * 1e-2), "b": {"c": torch.zeros(33)}}
    mean, new_err = compressed_psum(g, e, group)
    err = init_error_feedback({"g": torch.zeros(64)})
    trace = []
    for t in range(20):
        gt = {"g": torch.from_numpy(np.random.default_rng(
            1000 * t + d).normal(size=64).astype(np.float32) * (1 + d))}
        m, err = compressed_psum(gt, err, group)
        trace.append((gt["g"].numpy(), m["g"].numpy()))
    if mesh.get_local_rank("model") == 0:
        with open(out / f"compress-{d}.pkl", "wb") as f:
            pickle.dump({"g": g, "e": e, "mean": mean, "err": new_err,
                         "trace": trace,
                         "group_size": dist.get_world_size(group)}, f)


TRAIN_KW = dict(smoke=True, batch=4, seq=16, ckpt_every=3, lr=1e-3, seed=3,
                device="cpu")


def case_train(rank: int, out: Path, steps: int):
    """``launch.train.train`` over every rank's host mesh (world, 1) with
    ZeRO-1 moments and a checkpoint under ``ckpt/``, then the same call
    again (nothing left to do); rank 0 writes the losses, both start
    steps, the mesh and the final state whole (``train.pkl``)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as ttrain

    ttrain.FaultPolicy = _no_straggler()
    r = ttrain.train("granite-8b", steps=steps, ckpt_dir=str(out / "ckpt"),
                     **TRAIN_KW)
    again = ttrain.train("granite-8b", steps=steps,
                         ckpt_dir=str(out / "ckpt"), **TRAIN_KW)
    leaves = sh.leaves_with_path((r["params"], r["opt_state"]))
    full = {p: x.full_tensor().clone() for p, x in leaves}
    if rank == 0:
        with open(out / "train.pkl", "wb") as f:
            pickle.dump({"losses": r["losses"], "start": r["start_step"],
                         "again": again["start_step"], "state": full,
                         "mesh": tuple(leaves[1][1].device_mesh.shape),
                         "placements": {p: str(x.placements)
                                        for p, x in leaves}}, f)


def case_remesh(rank: int, out: Path):
    """``remesh_restore`` of ``ckpt/``'s latest (params, opt_state) onto
    ``plan_mesh(4, prefer_model=2)``: the mesh's shape and each leaf's
    placements and whole value (``remesh.pkl``, rank 0)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import family_module
    from repro_torch.optim import AdamW
    from repro_torch.runtime.elastic import remesh_restore

    cfg = get_config("granite-8b", smoke=True)
    params = family_module(cfg.family).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    template = (params, AdamW().init(params))
    state, es = remesh_restore(CheckpointManager(out / "ckpt"), template, 4,
                               prefer_model=2, device="cpu")
    got = {p: (str(x.placements), x.full_tensor().clone())
           for p, x in sh.leaves_with_path(state)}
    if rank == 0:
        with open(out / "remesh.pkl", "wb") as f:
            pickle.dump({"mesh": tuple(es.mesh.shape),
                         "names": tuple(es.mesh.mesh_dim_names),
                         "step": es.step, "state": got}, f)


def case_collectives(rank: int, out: Path):
    """granite-8b's smoke ``train_4k`` cell (``launch/dryrun``'s shapes
    and knobs, n_micro 1) as one real step over the (2, 2) host mesh:
    params from a seeded init placed by ``param_specs``, ZeRO-1 moments,
    a seeded batch placed by ``batch_specs``; counted by
    ``launch/cost.count``. Rank 0 writes the collectives by kind and
    their wire bytes (``collectives.json``)."""
    import json

    from repro_torch.configs import ShapeSpec, batch_specs, get_config
    from repro_torch.configs.shapes import SMOKE_OVERRIDES
    from repro_torch.launch import cost
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import family_module
    from repro_torch.optim import AdamW

    mesh = make_host_mesh(2, device="cpu")
    cfg = get_config("granite-8b", smoke=True)
    s, b = SMOKE_OVERRIDES["train"]
    shape = ShapeSpec("train_4k", "train", s, b)
    gen = torch.Generator().manual_seed(0)
    params = family_module(cfg.family).init(cfg, gen, device="cpu")
    opt = AdamW()
    state = opt.init(params)
    pspecs = sh.param_specs(params, mesh)
    params = sh.distribute(params, sh.named(pspecs, mesh), mesh)
    state = sh.distribute(state, sh.named(sh.opt_state_specs(
        state, pspecs, mesh, zero1=True), mesh), mesh)
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                              generator=gen, dtype=v.dtype)
             for k, v in batch_specs(cfg, shape).items()}
    batch = sh.distribute(batch, sh.named(sh.batch_specs(batch, mesh), mesh),
                          mesh)
    step = steps.make_train_step(cfg, opt, n_micro=1, grad_specs=pspecs)

    def run(*args):
        with sh.use_mesh(mesh):
            return step(*args)
    got = cost.count(run, params, state, batch)
    if rank == 0:
        (out / "collectives.json").write_text(json.dumps(
            {"collectives": got.cost.collectives, "wire": got.cost.wire,
             "n_collectives": got.cost.n_collectives}))


def _no_straggler():
    """``FaultPolicy`` with the straggler detector off (a loaded CPU trips
    it; the CPU tests of ``train`` all patch it so)."""
    from repro_torch.runtime.fault import FaultPolicy

    return lambda: FaultPolicy(straggler_tolerance=10**9)


CASES = {"steps": case_steps, "compress": case_compress, "train": case_train,
         "remesh": case_remesh, "collectives": case_collectives}


# --- the reference's side (a subprocess with forced devices) --------------------

REFERENCE = r'''
import json, pickle, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, str(Path(sys.argv[2])))
from torch_dist_helpers import ARCHS, STEPS, PEAK_LR, BATCH, SEQ, batch_np
from repro.configs import get_config
from repro.launch import sharding as sh
from repro.launch.steps import make_train_step
from repro.models import family_module
from repro.optim.adamw import AdamW
from repro.optim.schedule import warmup_cosine
from repro.runtime.elastic import plan_mesh

out = Path(sys.argv[1])
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    opt = AdamW(lr=warmup_cosine(PEAK_LR, 2, 10))
    params = family_module(cfg.family).init(cfg, jax.random.PRNGKey(0))
    with open(out / f"{arch}.init.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    state = opt.init(params)
    pspecs = sh.param_specs(params, mesh)
    named_p = sh.named(pspecs, mesh)
    named_o = sh.named(sh.opt_state_specs(state, pspecs, mesh, zero1=True),
                       mesh)
    params = jax.device_put(params, named_p)
    state = jax.device_put(state, named_o)
    with mesh:
        step = jax.jit(make_train_step(cfg, opt, grad_specs=pspecs),
                       in_shardings=(named_p, named_o, None),
                       out_shardings=(named_p, named_o, None))
    dump, losses = {}, []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in batch_np(cfg.vocab_size, i).items()}
        b = jax.device_put(b, sh.named(sh.batch_specs(b, mesh), mesh))
        with mesh:
            groups = sh.data_group_count(BATCH * SEQ)
            params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
        if i == 0:
            for pre, tree in (("p/", params), ("m/", state.m)):
                for path, x in jax.tree_util.tree_leaves_with_path(tree):
                    dump[pre + sh._path_str(path)] = np.asarray(
                        x.astype(jnp.float32))
    np.savez(out / f"{arch}.ref.npz", losses=np.array(losses),
             groups=np.array(groups), **dump)
grids = {f"{n},{m}": list(plan_mesh(n, prefer_model=m).devices.shape)
         for n in range(1, 17) for m in (16, 2)}
(out / "plan.json").write_text(json.dumps(grids))
'''
