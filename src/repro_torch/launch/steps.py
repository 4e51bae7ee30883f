"""Step builders — the port of ``repro/launch/steps.py``: the train, eval,
prefill and decode functions of an arch, through its family module, and
the decode step compiled as a captured CUDA graph (the counterpart of the
reference's jitted step).

The train step's gradients are taken with respect to per-layer leaves:
each stacked (L, ...) param (under the family module's ``STACKED``
subtrees) is handed to the loss as L detached views of
its storage (``models.dense.layer_slice`` indexes a list as it indexes
the stack), so a layer's backward writes its own gradient and never a
full-stack zero buffer. The reference's ``grad_specs`` (a sharding
argument) is not taken: sharding waits with tensor parallelism (ROADMAP
§A.4).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import graphs
from repro_torch.models import family_module
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map

def make_loss_fn(cfg):
    mod = family_module(cfg.family)

    def loss_fn(params, batch):
        return mod.train_loss(cfg, params, batch)

    return loss_fn


def _grad_leaves(params, stacked_keys):
    """(the params as the loss sees them, their grad leaves): every leaf a
    detached tensor requiring grad, one under a ``stacked_keys`` subtree as
    a list of per-layer views. The leaves list holds, per param leaf in
    sorted-key order, (its parts, whether it is stacked)."""
    leaves = []

    def rec(t, stacked):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rec(t[k], stacked)
            return out
        if stacked:
            parts = [t[i].detach().requires_grad_() for i in range(len(t))]
            leaves.append((parts, True))
            return parts
        leaves.append(([t.detach().requires_grad_()], False))
        return leaves[-1][0][0]

    tree = {k: None for k in params}
    for k in sorted(params):
        tree[k] = rec(params[k], k in stacked_keys)
    return tree, leaves


def accumulate_grads(cfg, params, batch, into) -> torch.Tensor:
    """The loss ``train_loss(cfg, params, batch)``, detached; its gradient
    is ADDED into ``into`` (a tree of the params' structure and shapes, in
    any float dtype), one part at a time as autograd hands it over (a
    stacked leaf's parts per layer), an unused leaf's part adding nothing.
    """
    mod = family_module(cfg.family)
    tree, leaves = _grad_leaves(params, mod.STACKED)
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
                (acc[j] if stacked else acc).add_(g.to(acc.dtype))
    return loss.detach()


def grads_like(params, dtype=None):
    """Zeros of the params' shapes, in ``dtype`` (default: each param's)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)


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


def make_train_step(cfg, opt: AdamW, n_micro: int = 1,
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
    not require grad (an engine can serve them)."""

    def step(params, opt_state, batch):
        grads = grads_like(params, None if n_micro == 1 else accum_dtype)
        losses = []
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            losses.append(accumulate_grads(cfg, params, mb, grads))
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
