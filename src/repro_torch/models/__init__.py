"""Model families behind one functional API — the port of
``repro/models/__init__.py``.

A family module exposes ``init``, ``train_loss(cfg, params, batch)``,
``prefill(cfg, params, batch, pad_to)``, ``decode_step(cfg, params,
cache, batch)`` (split into ``decode_check`` and ``decode_body``, which
``launch.steps`` captures) and ``cache_shape(cfg, batch, max_seq)``.
"""
from __future__ import annotations

import importlib

_FAMILIES = {
    "dense": "repro_torch.models.dense",
    "moe": "repro_torch.models.moe",
    "rglru": "repro_torch.models.rglru",
    "rwkv6": "repro_torch.models.rwkv6",
    "encdec": "repro_torch.models.encdec",
}


def family_module(family: str):
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family: {family!r}")
    return importlib.import_module(_FAMILIES[family])
