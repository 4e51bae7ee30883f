"""Architecture registry — the port of ``repro/configs/__init__.py``:
``get_config("<arch-id>")`` / ``--arch <id>`` over the ten arch modules,
each a copy of the reference's with ``CONFIG`` and ``SMOKE`` field for
field. The paper's own models (``paper_models``) and the dry-run's input
shapes (``shapes``) are exported here too.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_models import (LLAMA2_7B, OPT_1_3B, OPT_2_7B,
                                              OPT_6_7B, OPT_13B, OPT_30B,
                                              OPT_FAMILY, OPT_TINY)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        batch_specs, cache_specs)

_MODULES = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "applicable",
           "batch_specs", "cache_specs", "get_config", "LLAMA2_7B",
           "OPT_1_3B", "OPT_2_7B", "OPT_6_7B", "OPT_13B", "OPT_30B",
           "OPT_FAMILY", "OPT_TINY"]
