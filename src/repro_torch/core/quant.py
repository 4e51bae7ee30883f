"""Symmetric per-output-channel INT8 quantization (paper §4.1: all models
INT8) — the port of ``repro/core/quant.py``.

The flash tier stores quantized weights; the ECDP kernel accumulates
``a @ q`` and applies ``scale`` per output column (weight-only quantization
with bf16 activations, the paper's mixed BF16/INT8 MACs).
"""
from __future__ import annotations

import torch


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` (float) to INT8 with a per-channel scale.

    ``axis`` is the reduction axis; the scale keeps it (size 1) so that
    ``w ≈ q * scale``. Returns (q int8, scale float32), byte-identical to
    the JAX version: the same f32 ops, and round-half-to-even on both.
    """
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor, not a Python scalar: CUDA PyTorch turns a scalar
    # divisor into a multiply by its reciprocal, which can land one ulp off
    # the CPU's (and JAX's) true division and change q
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(w32 / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
