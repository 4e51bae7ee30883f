"""INT8 error-feedback gradient compression for the data-parallel
all-reduce — the port of ``repro/optim/grad_compress.py``'s mesh-free
half.

Each worker quantizes its gradient (plus the error it carried) to INT8
with a per-tensor scale, the int8 payloads are all-reduced, and the local
quantization residual is kept as error feedback for the next step: 4x
less wire traffic at <1e-2 relative error a step, with the accumulated
error vanishing. ``simulate_compressed_allreduce`` is the oracle over a
list of workers' trees. ``compressed_psum``, the reference's collective
inside a mesh, needs a process group and waits with tensor parallelism
(ROADMAP §A.4).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def _quantize(g, err):
    """(int8 payload, f32 scale, new error) of ``g + err``."""
    g = g.float() + err
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.float() * scale
    return q, scale, new_err


def simulate_compressed_allreduce(grads_per_worker, err_per_worker):
    """Workers' trees -> (the mean of their dequantized payloads, each
    worker's new error tree). Tests only."""
    n = len(grads_per_worker)
    outs, errs = [], []
    for g, e in zip(grads_per_worker, err_per_worker):
        qs = tree_map(_quantize, g, e)           # leaves (q, scale, err)
        outs.append(tree_map(lambda t: t[0].float() * t[1], qs))
        errs.append(tree_map(lambda t: t[2], qs))
    mean = tree_map(lambda *xs: sum(xs) / n, *outs)
    return mean, errs


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
