"""AdamW with a configurable moment dtype and global-norm clipping — the
port of ``repro/optim/adamw.py``.

State mirrors the params: a tree of nested dicts of tensors. Leaves are
visited in the JAX package's pytree order (dict keys sorted), which is the
order ``global_norm`` sums them in. The arithmetic follows the
reference's expression order: clip by the f32 global norm, moments
updated in f32 and stored in ``moment_dtype``, f32 bias correction, and
weight decay only on leaves with ``ndim >= 2`` (with stacked layers the
``(L, d)`` norm gains are such leaves, and decay, as in the reference).

``update`` is the reference's functional API. ``apply_`` is
``update`` + ``apply_updates`` done in place (the port's counterpart of
the reference train step's donated buffers): one leaf at a time, so the
f32 temporaries of a leaf are freed before the next leaf's exist.

Over a mesh the grads, moments and params of ``apply_`` are DTensors:
the global norm is summed over every shard, and each leaf's update is
computed on the local shards in the moments' placements (ZeRO-1 shards
them over "data" where the params are replicated), then brought to the
params' placements before the in-place add.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.sharding import is_dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure (the first's key
    order kept; leaves visited in sorted-key order)."""
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = tree_map(fn, tree[k], *(r[k] for r in rest))
        return out
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: str = "float32"

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    def init(self, params) -> AdamWState:
        dt = _DTYPES[self.moment_dtype]

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _coefs(self, grads, state: AdamWState):
        """(new step, (clip scale or None, lr, bias corrections)); the
        coefficients plain tensors (a DTensor's full value)."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gn = _full(global_norm(grads))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
        now = _full(step)
        t = now.to(torch.float32)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        return step, (scale, self._lr(now), bc1, bc2)

    def _leaf(self, g, m, v, p, coefs) -> torch.Tensor:
        """Advance one leaf's moments IN PLACE and return its update in p's
        dtype. Two f32 temporaries of the leaf's size (the scaled gradient,
        reused for the update, and one scratch): each op is the
        reference's, in its order, written into them."""
        scale, lr, bc1, bc2 = coefs
        b1, b2 = self.b1, self.b2
        g32 = g.float()
        own = g32 is not g                 # a copy: ours to overwrite
        if scale is not None:
            g32 = g32.mul_(scale) if own else g32 * scale
            own = True
        m32, v32 = m.float(), v.float()    # m, v themselves when f32
        t = torch.mul(g32, 1 - b1)
        m32.mul_(b1).add_(t)
        torch.mul(g32, 1 - b2, out=t).mul_(g32)
        v32.mul_(b2).add_(t)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
            m32, v32 = m.float(), v.float()
        d = torch.div(m32, bc1, out=g32) if own else m32 / bc1
        del m32
        d.div_(torch.div(v32, bc2, out=t).sqrt_().add_(self.eps))
        if self.weight_decay and p.ndim >= 2:   # no decay on norms/bias
            d.add_(t.copy_(p).mul_(self.weight_decay))
        del t
        return d.mul_(-lr).to(p.dtype)

    def update(self, grads, state: AdamWState, params):
        """(updates, new state); nothing passed in is changed."""
        step, coefs = self._coefs(grads, state)
        m = tree_map(torch.clone, state.m)
        v = tree_map(torch.clone, state.v)
        updates = tree_map(lambda g, mi, vi, p: self._leaf(g, mi, vi, p, coefs),
                           grads, m, v, params)
        return updates, AdamWState(step=step, m=m, v=v)

    @torch.no_grad()
    def apply_(self, grads, state: AdamWState, params) -> AdamWState:
        """``update`` then ``apply_updates``, in place: the params and the
        state's moments are written, one leaf at a time; returns the new
        state (its moments are the ones passed in)."""
        step, coefs = self._coefs(grads, state)
        for g, mi, vi, p in zip(tree_leaves(grads), tree_leaves(state.m),
                                tree_leaves(state.v), tree_leaves(params)):
            if is_dtensor(p):
                _apply_sharded(self, g, mi, vi, p, coefs)
            else:
                p.add_(self._leaf(g, mi, vi, p, coefs))
        return AdamWState(step=step, m=state.m, v=state.v)


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def _apply_sharded(opt: AdamW, g, m, v, p, coefs):
    """One DTensor leaf of ``apply_``: the gradient and the param brought
    to the moments' placements, ``_leaf`` on the local shards (every
    operand's shard covers the same elements), the update brought to the
    param's placements and added into its local shards."""
    from torch.distributed.tensor import DTensor
    mesh, pls = m.device_mesh, m.placements
    d = opt._leaf(g.redistribute(mesh, pls).to_local(), m.to_local(),
                  v.to_local(), p.redistribute(mesh, pls).to_local(), coefs)
    d = DTensor.from_local(d, mesh, pls, shape=p.shape, stride=p.stride())
    p.to_local().add_(d.redistribute(p.device_mesh, p.placements).to_local())


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))
