"""Which axis of a page-store entry shards over the "model" mesh — the port
of ``repro/launch/sharding.py``'s ``tp_shard_axis``, with the rule table it
reads (``_RULES``, ``_EXPERT_RE``), copied so that the serving shards and
the reference's training shards agree by construction.

The training specs (``param_specs``, ``guard`` and the rest) wait for
tensor-parallel training (ROADMAP §A.4).
"""
from __future__ import annotations

import re

MODEL = "model"

# (path regex, spec over the LAST TWO dims, fsdp dim index or None)
_RULES: tuple[tuple[str, tuple, int | None], ...] = (
    (r".*(embed|pos_embed)$", (MODEL, None), 1),             # (V, D)
    (r".*lm_head(/[012])?$", (None, MODEL), 0),              # (D, V)
    (r".*attn/w[qkv]$", (None, MODEL), 0),
    (r".*cross/w[qkv]$", (None, MODEL), 0),
    (r".*(attn|cross)/wo$", (MODEL, None), 1),
    (r".*(w_gate|w_up|w_in_x|w_in_y)(/[012])?$", (None, MODEL), 0),
    (r".*(w_down|w_out)(/[012])?$", (MODEL, None), 1),
    (r".*tmix/w_[rkvg](/[012])?$", (None, MODEL), 0),
    (r".*tmix/w_o(/[012])?$", (MODEL, None), 1),
    (r".*channel_mix/w_rgate(/[012])?$", (None, MODEL), 0),
    (r".*router$", (None, None), None),
)

_EXPERT_RE = re.compile(r".*experts/.*")


def tp_shard_axis(entry: str) -> int | None:
    """The (K, N) axis of store entry ``entry`` (``layers/ffn/w_up@3``;
    the ``@idx`` suffix is ignored) that shards for tensor-parallel
    streamed serving: 1 (column-parallel: w_gate / w_up, the d_ff axis) for
    a ``(None, MODEL)`` rule, 0 (row-parallel: w_down, the K axis, closed
    by one all-reduce) for a ``(MODEL, None)`` rule, None (replicated on
    every shard's pool) for the ``attn_flash/*`` copies and the rest."""
    base = entry.partition("@")[0]
    if base.startswith("attn_flash/"):
        return None                      # Alg.2 attn copies stay replicated
    for pat, last2, _ in _RULES:
        if re.fullmatch(pat, base):
            if last2 == (None, MODEL):
                return 1
            if last2 == (MODEL, None):
                return 0
            return None
    if _EXPERT_RE.match(base):
        # expert bank slices keep their per-matrix axis (the expert dim is
        # already split into per-entry store slices)
        leaf = base.rsplit("/", 1)[-1]
        if leaf in ("w_gate", "w_up"):
            return 1
        if leaf in ("w_down",):
            return 0
    return None
