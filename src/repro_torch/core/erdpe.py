"""ERDPE — the error-resilient dot-product engine — the port of
``repro/core/erdpe.py``.

``flash_matmul`` is how every layer consumes a flash-tier weight
(``FlashWeight``): it flattens leading batch/seq dims to an (M, K) GEMM,
runs the ECDP (``kernels/ecdp.py``) and restores the output shape. There is
no ``ExecMode``: the device of the tensors picks the kernel (CUDA) or its
plain version (CPU).
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.tiering import FlashWeight
from repro_torch.kernels.ecdp import ecdp_matmul


def serve_ecc_mode() -> str:
    """Serve-time ECC policy ("inline" | "load"), read at call time from
    ``REPRO_SERVE_ECC``. "inline" (the default, paper-faithful) corrects on
    every read of a flash-tier weight."""
    return os.environ.get("REPRO_SERVE_ECC", "inline")


def flash_matmul(x: torch.Tensor, w: FlashWeight, ecc_enabled: bool = True,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (..., K) activations; w: a single (K, N) FlashWeight.
    Returns (..., N) in ``out_dtype``."""
    if w.q.ndim != 2:
        raise ValueError("flash_matmul expects a single (K, N) FlashWeight; "
                         "index stacked layers before calling")
    k, n = w.q.shape
    lead = tuple(x.shape[:-1])
    out = ecdp_matmul(x.reshape(-1, k).contiguous(), w.q, w.parity, w.scale,
                      ecc_enabled=ecc_enabled)
    return out.reshape(lead + (n,)).to(out_dtype)


def maybe_flash_matmul(x: torch.Tensor, w, ecc_enabled: bool | None = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatch on tier: FlashWeight -> ERDPE; plain tensor -> matmul in
    the activation dtype."""
    if isinstance(w, FlashWeight):
        if ecc_enabled is None:
            ecc_enabled = serve_ecc_mode() == "inline"
        return flash_matmul(x, w, ecc_enabled=ecc_enabled, out_dtype=out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)
