"""Dense decoder-only transformer family — the port of the parts of
``repro/models/dense.py`` the serving slice uses: the norm and FFN
dispatch, ``attn_cfg``, and an ``init`` of the port's own.

Params are plain nested dicts of tensors with the JAX package's names and
layout: per-layer weights are stacked along a leading (L,) dim (the
serving engine indexes them in a Python layer loop — there is no scan).
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def _norm(cfg, x, p, name):
    if cfg.norm_type == "layer":
        return cm.layer_norm(x, p[f"{name}_g"], p[f"{name}_b"])
    return cm.rms_norm(x, p[name])


def attn_cfg(cfg) -> cm.AttnConfig:
    return cm.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, rope_base=cfg.rope_base,
        use_rope=cfg.use_rope, window=cfg.local_window,
    )


def _ffn_apply(cfg, p, x):
    if cfg.ffn_type == "swiglu":
        return cm.swiglu_apply(p, x)
    return cm.gelu_ffn_apply(p, x)


def init(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params with the shapes, distributions and scales of the JAX
    ``dense.init`` (bf16; dense_init / embed_init scales; LayerNorm gains 1
    and biases 0, RMSNorm gammas 0). Numbers are drawn on the generator's
    device and placed on ``device`` one (K, N) matrix at a time, so no
    full-model f32 temporary exists."""
    bf = torch.bfloat16
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    n_l = cfg.n_layers
    mats = {"attn": {"wq": (d, h * dh), "wk": (d, kv * dh),
                     "wv": (d, kv * dh), "wo": (h * dh, d)}}
    if cfg.ffn_type == "swiglu":
        mats["ffn"] = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    else:
        mats["ffn"] = {"w_up": (d, f), "w_down": (f, d)}
    layers: dict = {}
    for group, shapes in mats.items():
        layers[group] = {}
        for name, (k, n) in shapes.items():
            w = torch.empty((n_l, k, n), dtype=bf, device=device)
            for li in range(n_l):
                w[li] = cm.dense_init(generator, k, n, bf, device)
            layers[group][name] = w
    for name in ("ln1", "ln2"):
        if cfg.norm_type == "layer":
            layers[f"{name}_g"] = torch.ones((n_l, d), dtype=bf, device=device)
            layers[f"{name}_b"] = torch.zeros((n_l, d), dtype=bf, device=device)
        else:
            layers[name] = torch.zeros((n_l, d), dtype=bf, device=device)
    params = {
        "embed": cm.embed_init(generator, cfg.vocab_size, d, bf, device),
        "layers": layers,
        "final_norm": (torch.zeros((d,), dtype=bf, device=device)
                       if cfg.norm_type == "rms"
                       else {"g": torch.ones((d,), dtype=bf, device=device),
                             "b": torch.zeros((d,), dtype=bf, device=device)}),
        "lm_head": cm.dense_init(generator, d, cfg.vocab_size, bf, device),
    }
    if not cfg.use_rope:  # OPT-style learned positions
        params["pos_embed"] = cm.embed_init(generator, cfg.max_seq, d, bf,
                                            device)
    return params
