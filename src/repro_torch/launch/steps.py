"""Step builders — the port of the offline-inference half of
``repro/launch/steps.py``: the prefill and decode functions of an arch,
through its family module. Train and eval steps wait for the training
slice (ROADMAP A18).
"""
from __future__ import annotations

from repro_torch.models import family_module


def make_prefill_step(cfg, pad_to: int | None = None):
    """step(params, batch) -> (last_logits (B, V), cache)."""
    mod = family_module(cfg.family)

    def step(params, batch):
        return mod.prefill(cfg, params, batch, pad_to=pad_to)

    return step


def make_decode_step(cfg):
    """step(params, cache, batch) -> (logits (B, V), cache)."""
    mod = family_module(cfg.family)

    def step(params, cache, batch):
        return mod.decode_step(cfg, params, cache, batch)

    return step
