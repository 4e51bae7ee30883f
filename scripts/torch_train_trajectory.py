#!/usr/bin/env python3
"""The loss over 10 fresh-batch training steps, on the reference and on
the port, from the same params and batches, on the CPU.

chip_smoke.py's phase 15(a) trains granite-8b at full width (16 layers)
for 10 steps of fresh batches under ``warmup_cosine(3e-3, 2, 10)``, and its
loss rises (10.87 -> 19.71 at step 5 -> 14.68). This script asks whether
the reference does the same at a width the CPU can run: granite-8b's
layout (GQA 4:1, SwiGLU at d_ff = 3.5 d_model, head_dim 128, vocab 49152)
at ``--width`` and ``--layers``, ``--batch`` x ``--seq`` tokens a step as
2 microbatches, AdamW (the defaults: b1 0.9, b2 0.95, decay 0.1, clip 1)
under ``warmup_cosine(--lr, 2, 10)``. The JAX init makes the params and
``repro_torch.interop`` hands them to the port; all take each step's
batch from the same ``SyntheticLM`` source (the pipeline of either
package gives the same bytes). The reference runs twice: jitted, and op
by op (``jax.disable_jit()``, the port's oracle in the CPU tests: XLA
fuses the jitted step's bf16 elementwise chains, which the port rounds op
by op). The two reference runs show how far rounding alone moves the
trajectory; the port is held to the op-by-op run.

    PYTHONPATH=src python scripts/torch_train_trajectory.py \\
        [--width 1024] [--layers 4] [--seq 512] [--batch 2] [--lr 3e-3]

Prints each step's three losses; the last line is a JSON object. Exit
code 1 when a step's port and op-by-op reference losses differ by more
than ``--tol`` (1e-2).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--tol", type=float, default=1e-2)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    from repro.configs import get_config as jget
    from repro.data.pipeline import DataConfig, make_source
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import family_module as jfamily
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.schedule import warmup_cosine as jwarmup_cosine
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine

    heads = args.width // 128
    widths = dict(n_layers=args.layers, d_model=args.width, n_heads=heads,
                  n_kv_heads=max(heads // 4, 1), head_dim=128,
                  d_ff=args.width * 7 // 2)
    jcfg = dataclasses.replace(jget("granite-8b"), **widths)
    cfg = dataclasses.replace(get_config("granite-8b"), **widths)
    t0 = time.perf_counter()
    jp = jfamily(jcfg.family).init(jcfg, jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    jopt = JAdamW(lr=jwarmup_cosine(args.lr, 2, STEPS))
    topt = AdamW(lr=warmup_cosine(args.lr, 2, STEPS))
    jstep_eager = jmake_train_step(jcfg, jopt, n_micro=2)
    jstep = jax.jit(jstep_eager)
    tstep = make_train_step(cfg, topt, n_micro=2)
    ep, estate = jp, jopt.init(jp)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    print(f"granite-8b layout: {widths}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f} M params; {args.batch} x {args.seq} tokens "
          f"a step as 2 microbatches; warmup_cosine({args.lr:g}, 2, "
          f"{STEPS}); {torch.get_num_threads()} torch threads", flush=True)
    rows = []
    for i in range(STEPS):
        nb = source.batch(i)
        jb = {k: jax.numpy.asarray(v) for k, v in nb.items()}
        t1 = time.perf_counter()
        jp, jstate, jm = jstep(jp, jstate, jb)
        jl = float(jm["loss"])
        t2 = time.perf_counter()
        with jax.disable_jit():
            ep, estate, em = jstep_eager(ep, estate, jb)
            el = float(em["loss"])
        t3 = time.perf_counter()
        tp, tstate, tm = tstep(tp, tstate, {k: torch.from_numpy(v)
                                            for k, v in nb.items()})
        tl = float(tm["loss"])
        t4 = time.perf_counter()
        rows.append(dict(step=i, reference_jit=jl, reference_op_by_op=el,
                         port=tl, port_vs_op_by_op=tl - el,
                         jit_vs_op_by_op=jl - el,
                         seconds=[t2 - t1, t3 - t2, t4 - t3]))
        print(f"step {i}: reference jitted {jl:.5f}, op by op {el:.5f}; "
              f"port {tl:.5f}; port - op by op {tl - el:+.2e}, jitted - op "
              f"by op {jl - el:+.2e} ({t2 - t1:.1f} / {t3 - t2:.1f} / "
              f"{t4 - t3:.1f} s)", flush=True)
    worst = max(abs(r["port_vs_op_by_op"]) for r in rows)
    jit_gap = max(abs(r["jit_vs_op_by_op"]) for r in rows)
    agree = worst <= args.tol
    print(f"largest |port - op by op| {worst:.3e} (tol {args.tol:g}): "
          f"{'agree' if agree else 'DISAGREE'}; largest |jitted - op by "
          f"op| {jit_gap:.3e}; {time.perf_counter() - t0:.1f} s in all",
          flush=True)
    print(json.dumps(dict(widths=widths, vocab=cfg.vocab_size,
                          params_m=n_params / 1e6, batch=args.batch,
                          seq=args.seq, lr=args.lr, steps=rows,
                          max_port_vs_op_by_op=worst,
                          max_jit_vs_op_by_op=jit_gap, tol=args.tol,
                          agree=agree)))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
