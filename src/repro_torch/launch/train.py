"""Training driver: data pipeline + train step + fault tolerance + async
checkpointing, end to end — the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \
        --smoke --steps 30 --batch 8 --seq 64 --ckpt /tmp/ckpt

It trains on ``--device`` (``cuda`` unless ``--device cpu``). Alone, with
no process group, it trains on that one device with plain tensors. Over a
process group (``torchrun --nproc-per-node N -m repro_torch.launch.train
...``, or a caller that made one) it follows the reference: the host mesh
(world, 1) ("data", "model") (``--production``: the 16 x 16 mesh, which
needs a world of 256 ranks and raises on any other), the params' specs
and the ZeRO-1 moments' (``launch/sharding.py``), params and moments
distributed as DTensors, the step with ``grad_specs`` inside
``sharding.use_mesh``, and the restore onto the mesh. Every rank draws the
same params from ``seed`` and the same step's batch, and keeps its
shards. Restart-resume is exact: the data pipeline is step-functional and
the checkpoint stores (params, opt_state) and the step, in the JAX
package's on-disk format (rank 0 writes it; a mesh's checkpoint is the
same bytes as one device's). Params come from the family's ``init``
seeded by ``seed`` (the two packages draw different numbers; the batches
are the same).
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh, under_torchrun)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import family_module
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantExecutor

log = logging.getLogger("repro_torch.train")


def _to_batch(cfg, host_batch: dict, seq: int, d_model: int):
    """Adapt the token pipeline to family-specific batch structure."""
    if cfg.family == "encdec":
        b, s = host_batch["tokens"].shape
        return {
            "src_embeds": np.zeros((b, s, d_model), np.float32),
            "tgt_tokens": host_batch["tokens"],
            "labels": host_batch["labels"],
        }
    if cfg.frontend == "patch":
        b = host_batch["tokens"].shape[0]
        npatch = min(cfg.n_patch_tokens, 8)
        return {
            "tokens": host_batch["tokens"],
            "patch_embeds": np.zeros((b, npatch, d_model), np.float32),
            "labels": host_batch["labels"],
        }
    return host_batch


def train(arch: str, smoke: bool = True, steps: int = 20, batch: int = 8,
          seq: int = 64, ckpt_dir: str | None = None, ckpt_every: int = 10,
          production: bool = False, resume: bool = True, lr: float = 3e-3,
          n_micro: int = 1, seed: int = 0, fault_hook=None,
          device="cuda") -> dict:
    mesh = None
    if production:
        mesh = make_production_mesh(device=device)
    elif dist.is_initialized():
        mesh = make_host_mesh(device=device)
    cfg = get_config(arch, smoke=smoke)
    mod = family_module(cfg.family)

    opt = AdamW(lr=warmup_cosine(lr, steps // 10 + 1, steps))
    params = mod.init(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)
    opt_state = opt.init(params)
    pspecs, where = None, {"device": device}
    if mesh is not None:
        pspecs = sh.param_specs(params, mesh)
        named_p = sh.named(pspecs, mesh)
        named_o = sh.named(sh.opt_state_specs(opt_state, pspecs, mesh,
                                              zero1=True), mesh)
        params = sh.distribute(params, named_p, mesh)
        opt_state = sh.distribute(opt_state, named_o, mesh)
        where = {"placements": (named_p, named_o), "mesh": mesh}
    train_step = make_train_step(cfg, opt, n_micro=n_micro,
                                 grad_specs=pspecs)

    def step_fn(*args):
        # the loss read back inside the call the executor times: on the
        # card the read waits for the whole step, so the straggler
        # detector sees the device's time, not that of the launches
        with (sh.use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            params, opt_state, metrics = train_step(*args)
        return params, opt_state, {**metrics, "loss": float(metrics["loss"])}

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if manager and resume and manager.latest_step() is not None:
        (params, opt_state), extras = manager.restore((params, opt_state),
                                                      **where)
        start_step = int(extras["step"]) + 1
        log.info("resumed from step %d", start_step - 1)

    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    prefetch = Prefetcher(data, start_step=start_step)

    def restore_from_ckpt():
        # the reference's hook: reloads the checkpoint, and the executor
        # retries with the current arguments
        manager.restore((params, opt_state), **where)
        return None

    executor = FaultTolerantExecutor(
        step_fn, FaultPolicy(), fault_hook=fault_hook,
        on_restore=restore_from_ckpt if manager else None)

    losses = []
    t0 = time.time()
    step = start_step
    try:
        while step < steps:
            dstep, host_batch = prefetch.next()
            assert dstep == step, (dstep, step)
            batch_dict = {k: torch.from_numpy(v).to(device) for k, v in
                          _to_batch(cfg, host_batch, seq, cfg.d_model).items()}
            if mesh is not None:       # each rank keeps its data shard
                batch_dict = sh.distribute(batch_dict, sh.named(
                    sh.batch_specs(batch_dict, mesh), mesh), mesh)
            params, opt_state, metrics = executor.run_step(
                step, params, opt_state, batch_dict)
            losses.append(metrics["loss"])
            if not math.isfinite(losses[-1]):
                raise FloatingPointError(f"step {step}: loss {losses[-1]}")
            if manager and (step + 1) % ckpt_every == 0:
                manager.save_async(step, (params, opt_state), {"step": step})
            step += 1
    finally:
        prefetch.close()
    if manager:
        manager.save(steps - 1, (params, opt_state), {"step": steps - 1})
        manager.wait()
    dt = time.time() - t0
    if losses:
        log.info("trained %d steps in %.1fs; loss %.4f -> %.4f",
                 steps - start_step, dt, losses[0], losses[-1])
    else:
        log.info("nothing to do: checkpoint already at step %d", start_step)
    return {"losses": losses or [float("nan")], "params": params,
            "opt_state": opt_state, "seconds": dt, "start_step": start_step}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    if under_torchrun():                 # each rank joins the process group
        init_distributed(args.device)
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt,
                    production=args.production, lr=args.lr,
                    n_micro=args.n_micro, device=args.device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"loss: {out['losses'][0]:.4f} -> "
                  f"{out['losses'][-1]:.4f} ({out['seconds']:.1f}s)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
