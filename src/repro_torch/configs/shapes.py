"""The assigned input-shape set and its meta-tensor stand-ins — the port
of ``repro/configs/shapes.py``.

Every (arch x shape) cell is an ``ArchConfig`` with one of the four
``ShapeSpec``s. ``batch_specs`` and ``cache_specs`` describe a step's
inputs as meta tensors (shape and dtype, no storage), where the reference
returns ``jax.ShapeDtypeStruct``s: the dry-run (``launch/dryrun.py``)
makes its fake inputs from them.

Skip policy (DESIGN.md §4): long_500k needs sub-quadratic attention, so
only archs with ``cfg.sub_quadratic`` (recurrentgemma-9b, rwkv6-3b) run it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SMOKE_OVERRIDES = {"train": (64, 2), "prefill": (64, 2), "decode": (64, 2)}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: a 500k dense-KV decode is "
                       "not what this arch runs (DESIGN.md §4 skip note)")
    return True, ""


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _emb(shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> dict:
    """Meta tensors for the step's data batch (not params / cache)."""
    s, b = shape.seq_len, shape.global_batch
    if smoke:
        s, b = SMOKE_OVERRIDES[shape.kind]
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = s // 2
            d = {"src_embeds": _emb((b, half, cfg.d_model)),
                 "tgt_tokens": _tok((b, half))}
            if shape.kind == "train":
                d["labels"] = _tok((b, half))
            return d
        if cfg.frontend == "patch":
            npatch = min(cfg.n_patch_tokens, s // 2)
            d = {"tokens": _tok((b, s - npatch)),
                 "patch_embeds": _emb((b, npatch, cfg.d_model))}
            if shape.kind == "train":
                d["labels"] = _tok((b, s - npatch))
            return d
        d = {"tokens": _tok((b, s))}
        if shape.kind == "train":
            d["labels"] = _tok((b, s))
        return d
    # decode: one new token against a kv state of length seq_len
    return {"token": _tok((b,)), "kv_len": _tok((), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> dict:
    """Meta tensors for the decode step's KV cache / recurrent state, from
    the family's ``cache_shape``."""
    from repro_torch.models import family_module
    s, b = shape.seq_len, shape.global_batch
    if smoke:
        s, b = SMOKE_OVERRIDES["decode"]
    mod = family_module(cfg.family)
    if cfg.family == "encdec":
        return mod.cache_shape(cfg, b, s, src_len=max(s // 8, 8))
    return mod.cache_shape(cfg, b, s)
