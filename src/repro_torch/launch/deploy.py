"""Deployment: convert a bf16 checkpoint into the tiered NVLLM form — the
port of ``repro/launch/deploy.py``.

    PYTHONPATH=src python -m repro_torch.launch.deploy --arch granite-8b \
        --smoke --ckpt /tmp/ckpt --out /tmp/deployed --rber 1e-4

This is the paper's "flash programming" step (§3.5: Q/K/V/O copied once to
DRAM at init; FFN weights quantized INT8, ECC-encoded, page-laid-out in
NAND). ``--rber`` injects raw-NAND bit errors into the stored codewords so
the serving path exercises the ERDPE correction machinery end to end.

``--store nand.img`` programs the flash tier into a page-granular die
image (16 KiB plane-interleaved pages + JSON page table; ``PageStore.open``
mmaps it back bit-exactly) and checkpoints only the DRAM tier next to it;
``python -m repro_torch.launch.serve --store-image nand.img --ckpt OUT``
serves it. The image, its page table and the checkpoint are the JAX
package's formats: given the same params, the two packages write the same
bytes.

Params come from ``--ckpt`` (a training checkpoint of (params, AdamW
state), or a params checkpoint, in the JAX package's format), restored
whole, or, without it, from the family's ``init`` seeded by ``seed``
(random: the two packages draw different numbers), the flash tier encoded
as it is drawn (``tiering.deploy_init``). Encoding runs on
``--device`` (``cuda`` unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.tiering import (deploy, deploy_init, flash_bytes,
                                      init_template)
from repro_torch.optim.adamw import AdamWState


def run_deploy(arch: str, smoke: bool, ckpt_dir: str | None, out_dir: str,
               rber: float = 0.0, seed: int = 0,
               store_path: str | None = None, device="cuda") -> dict:
    cfg = get_config(arch, smoke=smoke)
    store = None
    if store_path is not None:
        from repro_torch.store import PageStore
        store = PageStore()
    if ckpt_dir:
        # a training checkpoint holds (params, AdamW state); a deploy's
        # own, params alone. The template's leaves are read for their
        # place only: the init tree on the meta device, nothing drawn, and
        # the AdamW state's is the params tree itself (the tree of
        # AdamW().init(params), without its moments' memory)
        params = init_template(cfg)
        mgr = CheckpointManager(ckpt_dir)
        state = AdamWState(step=torch.zeros((), dtype=torch.int32),
                           m=params, v=params)
        try:
            (params, _), _ = mgr.restore((params, state), device=device)
        except ValueError:
            params, _ = mgr.restore(params, device=device)
        tiered, tier_map = deploy(params, rber=rber, seed=seed, store=store)
    else:
        # the flash tier encoded as it is drawn: no flash leaf in bf16;
        # attention is DRAM tier, drawn whole, bf16
        tiered, tier_map = deploy_init(
            cfg, torch.Generator(device=device).manual_seed(seed),
            rber=rber, seed=seed, store=store, device=device)
        params = tiered
    if store is not None and cfg.family == "dense":
        # the streamed engine also needs per-layer flash Q/K/V/O copies
        # (Alg. 2's in-flash projection targets); program them into the
        # image so it is SELF-CONTAINED — ``serve --store-image`` opens it
        # read-only and has nothing left to program. (MoE attention stays
        # DRAM-tier.)
        from repro_torch.core.tiering import program_attn_flash
        program_attn_flash(store, params["layers"]["attn"], cfg.n_layers,
                           rber=rber, seed=seed)
    fb, db = flash_bytes(tiered)
    out = CheckpointManager(out_dir, keep=1)
    if store is not None:
        # flash tier -> the page-granular NAND die image (mmap'able at
        # serve time); the checkpoint keeps only the DRAM tier.
        from repro_torch.store import drop_store_refs
        store.save(store_path)
        out.save(0, drop_store_refs(tiered),
                 {"arch": arch, "rber": rber, "flash_bytes": fb,
                  "dram_bytes": db, "store": store_path})
    else:
        out.save(0, tiered, {"arch": arch, "rber": rber,
                             "flash_bytes": fb, "dram_bytes": db})
    n_flash = sum(1 for t in tier_map.values() if t == "flash")
    stats = {
        "arch": arch,
        "flash_gib": fb / 2**30,
        "dram_gib": db / 2**30,
        "flash_leaves": n_flash,
        "dram_leaves": len(tier_map) - n_flash,
        "flash_fraction": fb / max(fb + db, 1),
    }
    if store is not None:
        stats["store"] = {"path": store_path, **store.stats()}
    print(json.dumps(stats, indent=1))
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rber", type=float, default=0.0)
    ap.add_argument("--store", default=None, metavar="IMAGE",
                    help="serialize the flash tier into a page-granular "
                         "NAND die image (+ .meta.json page table) instead "
                         "of checkpointing it as device arrays")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where params are made and encoded")
    args = ap.parse_args()
    run_deploy(args.arch, args.smoke, args.ckpt, args.out, args.rber,
               store_path=args.store, device=args.device)


if __name__ == "__main__":
    main()
