#!/usr/bin/env python3
"""Training on the card, beyond what ``chip_smoke.py`` gates: four parts,
each printed as it ends (one failing part does not stop the others; the
exit code is non-zero if any failed).

  phase15   chip_smoke's phase 15 alone (15(a), (b), (c), as the script
            runs it), timed.
  lr        15(a)'s shape (granite-8b at full width, TRAIN_LAYERS layers,
            10 steps of 2 x 4096 tokens, n_micro 2) at lower peak rates
            than its 3e-3: does the loss fall?
  overfit   15(a)'s shape at a peak of 3e-4, every step on the same batch
            (step 0's): the loss of the batch the steps train on.
  rwkv6     where rwkv6-3b's card-vs-CPU gradient gap (15(c)) comes from:
            the gradient of one 15(c) step (the sum over its 2
            microbatches, before clipping) of rwkv6-3b at full width, 1 and
            2 layers, on the card in bf16 (cuBLAS's reduced-precision bf16
            reductions on, PyTorch's default, and off), on the CPU in bf16,
            and in f32 on both (the params cast up, TF32 off): each leaf's
            max |a - b| / max |reference| for each pair, the worst leaves.

Needs one card:

    python3 scripts/train_diagnostics.py [phase15] [lr] [overfit] [rwkv6]

(all four when none is named). Prints the card's name and power limit
first; the last line is a JSON object of every part's figures.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

LOWER_LRS = (1e-3, 3e-4)
RWKV_LAYERS = (1, 2)


def part_phase15(torch) -> dict:
    t0 = time.perf_counter()
    out = cs.phase_train(torch)
    out["seconds"] = time.perf_counter() - t0
    cs.log(f"  phase 15 in {out['seconds']:.1f} s")
    return out


def part_lr(torch) -> dict:
    out = {}
    for lr in LOWER_LRS:
        cs.log(f"  15(a)'s shape at warmup_cosine({lr:g}, 2, 10)")
        r = cs.train_full(torch, lr=lr, profiled=False)
        out[str(lr)] = dict(losses=r["losses"], grad_norms=r["grad_norms"],
                            ms_per_step=r["ms_per_step"])
    return out


def part_overfit(torch) -> dict:
    cs.log("  15(a)'s shape at warmup_cosine(0.0003, 2, 10), batch 0 at "
           "every step")
    r = cs.train_full(torch, lr=3e-4, profiled=False, fixed_batch=True)
    return dict(losses=r["losses"], grad_norms=r["grad_norms"])


def rwkv6_grads(torch, cfg, params, batch, device, reduced=True):
    """The f32 sum of the 2 microbatches' gradients, leaves on the card."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import tree_leaves

    flag = torch.backends.cuda.matmul
    kept = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = reduced
    try:
        into = steps.grads_like(params, torch.float32)
        for i in range(2):
            steps.accumulate_grads(
                cfg, params, {k: v[i:i + 1].to(device)
                              for k, v in batch.items()}, into)
    finally:
        flag.allow_bf16_reduced_precision_reduction = kept
    return [g.cuda() for g in tree_leaves(into)]


def part_rwkv6(torch) -> dict:
    from repro_torch.models import family_module
    from repro_torch.optim.adamw import tree_leaves, tree_map

    arch = "rwkv6-3b"
    _, _, batch, _, _ = cs.parity_inputs(torch, arch)
    out = {}
    for layers in RWKV_LAYERS:
        cfg = cs.train_cfg(arch, n_layers=layers)
        p = family_module(cfg.family).init(
            cfg, torch.Generator(device="cuda").manual_seed(21),
            device="cuda")
        names = cs.leaf_names(p)
        f32 = tree_map(lambda t: t.float(), p)
        runs = {
            "card f32": rwkv6_grads(torch, cfg, f32, batch, "cuda"),
            "card bf16": rwkv6_grads(torch, cfg, p, batch, "cuda"),
            "card bf16 no-rpr": rwkv6_grads(torch, cfg, p, batch, "cuda",
                                            reduced=False),
        }
        cpu = tree_map(lambda t: t.cpu(), p)
        runs["cpu bf16"] = rwkv6_grads(torch, cfg, cpu, batch, "cpu")
        runs["cpu f32"] = rwkv6_grads(
            torch, cfg, tree_map(lambda t: t.float(), cpu), batch, "cpu")
        del cpu, f32
        pairs = [("card bf16", "cpu bf16"), ("card bf16 no-rpr", "cpu bf16"),
                 ("card bf16", "card bf16 no-rpr"), ("card bf16", "card f32"),
                 ("card bf16 no-rpr", "card f32"), ("cpu bf16", "card f32"),
                 ("cpu f32", "card f32")]
        res = {}
        for a, b in pairs:
            rel = [(float((x - y).abs().max()
                          / y.abs().max().clamp_min(1e-30)), n)
                   for n, x, y in zip(names, runs[a], runs[b])]
            rel.sort(reverse=True)
            res[f"{a} vs {b}"] = dict(worst=rel[:4], w_k=[
                r for r in rel if r[1].endswith("tmix/w_k")][0][0])
            cs.log(f"  rwkv6-3b {layers} layer(s), {a} vs {b}: worst "
                   f"{[(round(r, 5), n) for r, n in rel[:4]]}; tmix/w_k "
                   f"{res[f'{a} vs {b}']['w_k']:.5f}")
        out[str(layers)] = res
        del runs, p
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_diagnostics: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = {"phase15": part_phase15, "lr": part_lr,
             "overfit": part_overfit, "rwkv6": part_rwkv6}
    names = sys.argv[1:] or list(parts)
    out, failed = {"device": smi}, []
    for name in names:
        cs.log(f"part {name}")
        t0 = time.perf_counter()
        try:
            out[name] = parts[name](torch)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        cs.log(f"  part {name} in {time.perf_counter() - t0:.1f} s")
    out["failed"] = failed
    print(json.dumps(out, default=str), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
