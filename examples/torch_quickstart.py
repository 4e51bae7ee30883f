"""Quickstart on the PyTorch port: the NVLLM execution model in 60 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. build a small llama-style model,
2. deploy it into the tiered NVLLM form — FFN + LM head become INT8
   codewords + Hamming(72,64) parity ("flash tier"), attention stays bf16
   ("DRAM tier"),
3. inject raw-NAND bit errors and run a forward pass: the error-resilient
   dot-product engine (ERDPE) detects and corrects inline,
4. compare against the clean deployment: identical logits.

It runs on the card (the ECDP kernel reads the flash tier) unless
``--device cpu`` asks for the plain kernel versions. The same steps as
``examples/quickstart.py``, through ``repro_torch``.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.tiering import deploy, flash_bytes
from repro_torch.models import dense


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    cfg = get_config("granite-8b", smoke=True)
    params = dense.init(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))

    # -- deploy: "flash programming" (write-once, endurance-friendly) -------
    clean, tier_map = deploy(params, rber=0.0)
    noisy, _ = deploy(params, rber=1e-5, seed=42)   # raw NAND read errors
    fb, db = flash_bytes(clean)
    n_flash = sum(1 for t in tier_map.values() if t == "flash")
    print(f"tiered deployment: {n_flash} flash-tier tensors "
          f"({fb/1024:.0f} KiB incl. 12.5% ECC), "
          f"{len(tier_map)-n_flash} DRAM-tier ({db/1024:.0f} KiB)")

    # -- forward on raw (possibly corrupted) NAND reads ----------------------
    with torch.no_grad():
        logits_clean = dense.forward(cfg, clean, tokens)
        logits_noisy = dense.forward(cfg, noisy, tokens)
    err = float((logits_clean - logits_noisy).abs().max())
    print(f"max |logit drift| under RBER=1e-5 with inline ECC: {err:.2e}")
    assert err < 1e-2, "ERDPE must repair single-bit errors exactly"

    # -- the same model still trains (bf16 master weights) -------------------
    loss = dense.train_loss(cfg, params, {"tokens": tokens, "labels": tokens})
    print(f"train loss (bf16 master): {float(loss):.4f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
