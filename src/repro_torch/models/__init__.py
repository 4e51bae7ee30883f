"""Model families behind one functional API — the port of
``repro/models/__init__.py``.

A family module exposes ``init``, ``prefill(cfg, params, batch, pad_to)``,
``decode_step(cfg, params, cache, batch)`` and ``cache_shape(cfg, batch,
max_seq)``. The port holds the dense family so far.
"""
from __future__ import annotations

import importlib

_FAMILIES = {"dense": "repro_torch.models.dense"}
# families of the reference the port does not hold yet, and where ROADMAP.md
# queues them
_NOT_PORTED = {"moe": "ROADMAP A12",
               "rglru": "ROADMAP A17", "rwkv6": "ROADMAP A17",
               "encdec": "ROADMAP A17"}


def family_module(family: str):
    if family in _NOT_PORTED:
        raise KeyError(f"model family {family!r} is not ported yet: "
                       f"{_NOT_PORTED[family]}")
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family: {family!r}")
    return importlib.import_module(_FAMILIES[family])
