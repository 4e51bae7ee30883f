"""Step builders — the port of ``repro/launch/steps.py``: the train, eval,
prefill and decode functions of an arch, through its family module, and
the decode step compiled as a captured CUDA graph (the counterpart of the
reference's jitted step).

The train step's gradients are taken with respect to per-layer leaves:
each stacked (L, ...) param (under the family module's ``STACKED``
subtrees) is handed to the loss as L detached views of
its storage (``models.dense.layer_slice`` indexes a list as it indexes
the stack), so a layer's backward writes its own gradient and never a
full-stack zero buffer.

Over a ("data", "model") mesh (``launch/sharding.py``) the params, the
moments and the batch are DTensors and the step runs inside
``sharding.use_mesh``: ``grad_specs`` (the params' specs) puts every
weight through ``sharding.pin_grad``, so each layer's gradient arrives in
its param's shards; the accumulators carry the params' placements, and a
gradient is added into its accumulator's local shards. The microbatch
split keeps the batch dim data-sharded.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import graphs
from repro_torch.launch import sharding as sh
from repro_torch.models import family_module
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map

def make_loss_fn(cfg):
    mod = family_module(cfg.family)

    def loss_fn(params, batch):
        return mod.train_loss(cfg, params, batch)

    return loss_fn


def _grad_leaves(params, stacked_keys, grad_specs=None):
    """(the params as the loss sees them, their grad leaves): every leaf a
    detached tensor requiring grad, one under a ``stacked_keys`` subtree as
    a list of per-layer views. The leaves list holds, per param leaf in
    sorted-key order, (its parts, whether it is stacked). With
    ``grad_specs`` the loss sees each part through ``sharding.pin_grad``
    (a layer's part with its stack's spec less the layer dim)."""
    leaves = []

    def rec(t, spec, stacked):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rec(t[k], None if spec is None else spec[k], stacked)
            return out
        if stacked:
            parts = [t[i].detach().requires_grad_() for i in range(len(t))]
            leaves.append((parts, True))
            if spec is None:
                return parts
            return [sh.pin_grad(x, tuple(spec)[1:]) for x in parts]
        leaves.append(([t.detach().requires_grad_()], False))
        x = leaves[-1][0][0]
        return x if spec is None else sh.pin_grad(x, tuple(spec))

    tree = {k: None for k in params}
    for k in sorted(params):
        tree[k] = rec(params[k], None if grad_specs is None else grad_specs[k],
                      k in stacked_keys)
    return tree, leaves


def _add_part(acc, j, g):
    """acc (or its layer ``j``) += g. A DTensor gradient is brought to the
    accumulator's placements (a layer's: the stack's, one dim down) and
    added into the accumulator's local shards."""
    if not sh.is_dtensor(acc):
        (acc if j is None else acc[j]).add_(g.to(acc.dtype))
        return
    from torch.distributed.tensor import Shard
    pls = acc.placements if j is None else [
        Shard(p.dim - 1) if isinstance(p, Shard) else p
        for p in acc.placements]
    local = g.redistribute(acc.device_mesh, pls).to_local()
    dst = acc.to_local()
    (dst if j is None else dst[j]).add_(local.to(acc.dtype))


def accumulate_grads(cfg, params, batch, into, grad_specs=None
                     ) -> torch.Tensor:
    """The loss ``train_loss(cfg, params, batch)``, detached; its gradient
    is ADDED into ``into`` (a tree of the params' structure and shapes, in
    any float dtype), one part at a time as autograd hands it over (a
    stacked leaf's parts per layer), an unused leaf's part adding nothing.
    ``grad_specs``: the params' specs, every weight pinned to them
    (``_grad_leaves``); DTensor params and accumulators are called inside
    ``sharding.use_mesh``. The loss is a plain tensor on every rank.
    """
    mod = family_module(cfg.family)
    tree, leaves = _grad_leaves(params, mod.STACKED, grad_specs)
    flat = [x for parts, _ in leaves for x in parts]
    with torch.enable_grad():
        loss = mod.train_loss(cfg, tree, batch)
        gs = list(torch.autograd.grad(loss, flat, allow_unused=True))
    del tree, flat
    n = 0
    for acc, (parts, stacked) in zip(tree_leaves(into), leaves):
        for j in range(len(parts)):
            g, gs[n] = gs[n], None        # freed as soon as it is added
            n += 1
            if g is not None:
                _add_part(acc, j if stacked else None, g)
    loss = loss.detach()
    return loss.full_tensor() if sh.is_dtensor(loss) else loss


def grads_like(params, dtype=None):
    """Zeros of the params' shapes, in ``dtype`` (default: each param's);
    a DTensor param's with its placements."""
    def zeros(p):
        if sh.is_dtensor(p):
            return torch.zeros_like(p, dtype=dtype or p.dtype)
        return torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
    return tree_map(zeros, params)


def value_and_grad(cfg, params, batch):
    """(loss, grads) of ``train_loss(cfg, params, batch)``, grads in the
    params' dtypes (``jax.value_and_grad``'s contract), an unused leaf's
    zero."""
    grads = grads_like(params)
    return accumulate_grads(cfg, params, batch, grads), grads


def make_prefill_step(cfg, pad_to: int | None = None):
    """step(params, batch) -> (last_logits (B, V), cache). Never captured:
    one call per prompt batch."""
    mod = family_module(cfg.family)

    def step(params, batch):
        return mod.prefill(cfg, params, batch, pad_to=pad_to)

    return step


def make_decode_step(cfg, compiled: bool = False):
    """step(params, cache, batch) -> (logits (B, V), cache), the family's
    ``decode_step``.

    ``compiled=True``: on the card, the step's body (``decode_body``) is
    captured in a CUDA graph once per (params, cache tensors, batch size)
    and replayed: ``token`` and ``kv_len`` are copied into static buffers
    before each replay (``kv_len`` checked on the host first, as the eager
    step checks it), the cache is written in place, and each call returns
    a fresh logits tensor. ``step.captures`` counts the captures: a new
    cache, even at the same shape, is a new capture (a cache is never
    copied into a static one); ``step.captured`` is the current one
    (``graphs.Captured``). The cache is any family's dict of tensors,
    written in place (dense K/V; RWKV-6's state; the RG-LRU states and
    ring; the encoder-decoder's self- and cross-KV): a capture holds
    every tensor's address; a family's ``RECURRENT_STATE`` entries
    (advanced, not only written, by a step) are put back after the
    capture's warm-up. The kernel launch counters tick at the
    warm-up and the capture, not at a replay (``repro_torch.graphs``). On
    the CPU the body runs eagerly and nothing is captured. A failed
    capture raises."""
    mod = family_module(cfg.family)
    if not compiled:
        def step(params, cache, batch):
            return mod.decode_step(cfg, params, cache, batch)
        return step

    held = {}             # the current capture's key, params, cache, inputs

    def step(params, cache, batch):
        token = batch["token"]
        if not token.is_cuda:
            return mod.decode_step(cfg, params, cache, batch)
        kv_len = mod.decode_check(cache, batch)
        key = (id(params), tuple(token.shape))
        live = held.get("cache")
        if (held.get("key") != key or live is None
                or live.keys() != cache.keys()
                or any(live[k]() is not t for k, t in cache.items())):
            held.clear()             # drops the old graph and its pool
            step.captured = None
            held.update(key=key, params=params,
                        cache={k: weakref.ref(t) for k, t in cache.items()},
                        tok=torch.empty(token.shape, dtype=torch.int64,
                                        device=token.device),
                        pos=torch.empty((1,), dtype=torch.int64,
                                        device=token.device))
        tok, pos = held["tok"], held["pos"]
        tok.copy_(token, non_blocking=True)
        pos.fill_(kv_len)
        with torch.no_grad():
            if step.captured is None:
                # the capture's eager warm-up runs the body once: a KV row
                # it wrote is written again, the same, by the replay, but
                # a recurrent state it advanced would be advanced twice
                kept = {k: cache[k].clone()
                        for k in getattr(mod, "RECURRENT_STATE", ())
                        if k in cache}
                step.captured = graphs.capture(
                    lambda: mod.decode_body(cfg, params, cache, tok, pos))
                for k, t in kept.items():
                    cache[k].copy_(t)
                step.captures += 1
            logits = step.captured.replay()
        return logits.clone(), cache

    step.captures = 0
    step.captured = None
    return step


def _microbatch(v, n_micro: int, i: int):
    """Rows [i * B/n_micro, (i+1) * B/n_micro) of batch leaf ``v``; a
    DTensor's taken from its whole value (token ids: small) and put back
    in ``v``'s placements, so the microbatch stays batch-sharded (the
    reference's constraint on the split)."""
    m = v.shape[0] // n_micro
    if not sh.is_dtensor(v):
        return v.reshape((n_micro, m) + tuple(v.shape[1:]))[i]
    return sh.like(sh.whole(v)[i * m:(i + 1) * m], v)


def make_train_step(cfg, opt: AdamW, n_micro: int = 1, grad_specs=None,
                    accum_dtype=torch.float32):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``n_micro > 1`` splits the batch's rows into n_micro microbatches,
    sums each one's gradients into ``accum_dtype`` zeros and divides by
    n_micro (the reference's scan, as a loop); the loss is the microbatch
    losses' mean. With ``n_micro == 1`` the gradients are in the params'
    dtypes (bf16), added into zeros (exact). The update is ``AdamW.apply_``: the params and the
    state's moments are written IN PLACE (the port's counterpart of the
    reference's donated buffers), so a caller that needs the old ones
    passes copies; the returned params are the tensors passed in, which do
    not require grad (an engine can serve them).

    Over a mesh: params, moments and batch are DTensors
    (``sharding.distribute``), ``grad_specs`` the params' specs
    (``sharding.param_specs``), and the caller enters
    ``sharding.use_mesh``; the metrics' loss is a plain tensor."""

    def step(params, opt_state, batch):
        grads = grads_like(params, None if n_micro == 1 else accum_dtype)
        losses = []
        for i in range(n_micro):
            mb = {k: _microbatch(v, n_micro, i) for k, v in batch.items()}
            losses.append(accumulate_grads(cfg, params, mb, grads,
                                           grad_specs))
        loss = losses[0]
        if n_micro > 1:
            loss = torch.zeros((), dtype=torch.float32, device=loss.device)
            for l in losses:
                loss = loss + l
            loss = loss / n_micro
            for g in tree_leaves(grads):
                g.div_(n_micro)
        opt_state = opt.apply_(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


def make_eval_step(cfg):
    """step(params, batch) -> the loss, no gradient kept."""
    loss_fn = make_loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return step
