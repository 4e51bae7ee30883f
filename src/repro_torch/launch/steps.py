"""Step builders — the port of the offline-inference half of
``repro/launch/steps.py``: the prefill and decode functions of an arch,
through its family module, and the decode step compiled as a captured CUDA
graph (the counterpart of the reference's jitted step). Train and eval
steps wait for the training slice (ROADMAP §A.6).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import graphs
from repro_torch.models import family_module


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
