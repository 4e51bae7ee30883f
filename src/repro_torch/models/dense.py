"""Dense decoder-only transformer family — the port of
``repro/models/dense.py``: the norm and FFN dispatch, ``attn_cfg``, an
``init`` of the port's own, and the offline inference API — ``forward``,
``prefill``, ``decode_step`` (a host check and a device body, which
``launch.steps`` captures in a CUDA graph), ``cache_shape``.

Params are plain nested dicts of tensors with the JAX package's names and
layout: per-layer weights (bf16 tensors or stacked ``FlashWeight``s) are
stacked along a leading (L,) dim and indexed in a Python layer loop —
there is no scan. Cache layout: K/V (L, B, S, KV, Dh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
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


def layer_slice(tree, li):
    """Layer ``li`` of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, li) for k, v in tree.items()}
    return tree[li]


def _final_norm(cfg, params, x):
    if cfg.norm_type == "rms":
        return cm.rms_norm(x, params["final_norm"])
    return cm.layer_norm(x, params["final_norm"]["g"],
                         params["final_norm"]["b"])


def _layer_fwd(cfg, x, lp, positions, collect_kv=True):
    """Full-sequence layer forward; returns (x, (k, v) or None)."""
    h = _norm(cfg, x, lp, "ln1")
    q, k, v = cm.qkv_project(lp["attn"], h, attn_cfg(cfg), positions)
    attn = cm.chunked_attention(q, k, v, causal=True, window=cfg.local_window)
    b, s, _, _ = attn.shape
    attn = maybe_flash_matmul(attn.reshape(b, s, -1), lp["attn"]["wo"])
    x = x + attn
    x = x + _ffn_apply(cfg, lp["ffn"], _norm(cfg, x, lp, "ln2"))
    return x, ((k, v) if collect_kv else None)


def _embed(cfg, params, tokens, positions, extra_embeds=None):
    x = params["embed"][tokens.long()]
    if not cfg.use_rope and "pos_embed" in params:
        x = x + params["pos_embed"][positions.long()]
    if extra_embeds is not None:  # VLM: prepend patch embeddings (stub frontend)
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def forward(cfg, params, tokens, extra_embeds=None, return_cache=False):
    """Prefill forward. tokens (B, S) -> logits (B, S_tot, V) f32, and with
    ``return_cache`` the cache {"k"/"v": (L, B, S_tot, KV, Dh)}."""
    b, s = tokens.shape
    n_extra = extra_embeds.shape[1] if extra_embeds is not None else 0
    positions = torch.arange(s + n_extra, device=tokens.device)
    x = _embed(cfg, params, tokens, positions[n_extra:], extra_embeds)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        x, kv = _layer_fwd(cfg, x, layer_slice(params["layers"], li),
                           positions, collect_kv=return_cache)
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = _final_norm(cfg, params, x)
    logits = maybe_flash_matmul(x, params["lm_head"], out_dtype=torch.float32)
    if return_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits


def prefill(cfg, params, batch, pad_to: int | None = None):
    """Returns (last_logits (B, V), cache). batch: {"tokens" (B, S)[,
    "patch_embeds"]}. Cache padded with zero rows to ``pad_to``."""
    extra = batch.get("patch_embeds")
    logits, cache = forward(cfg, params, batch["tokens"], extra_embeds=extra,
                            return_cache=True)
    if pad_to is not None:
        s = cache["k"].shape[2]
        if pad_to < s:
            raise ValueError(f"prefill: pad_to {pad_to} < sequence {s}")
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, pad_to - s))
                 for k, v in cache.items()}
    return logits[:, -1], cache


def decode_check(cache, batch) -> int:
    """The host half of ``decode_step``: batch["kv_len"] as an int, which
    must lie in [0, S_max) (the reference's ``dynamic_update_slice`` clamps
    a start past the cache; here it raises, before anything is written)."""
    kv_len = int(batch["kv_len"])
    s_max = cache["k"].shape[2]
    if not 0 <= kv_len < s_max:
        raise ValueError(f"decode_step: kv_len {kv_len} outside the cache's "
                         f"{s_max} rows")
    return kv_len


def decode_body(cfg, params, cache, token, kv_len):
    """The device half of ``decode_step``: token (B,) int, kv_len a (1,)
    int64 device tensor (a checked one). Reads no tensor on the host, so
    ``launch.steps.make_decode_step(compiled=True)`` captures it. Returns
    the logits (B, V) f32; the cache is written in place."""
    positions = kv_len.reshape(1)
    x = _embed(cfg, params, token[:, None], positions)
    for li in range(cfg.n_layers):
        lp = layer_slice(params["layers"], li)
        h = _norm(cfg, x, lp, "ln1")
        q, k, v = cm.qkv_project(lp["attn"], h, attn_cfg(cfg), positions)
        attn = cm.decode_attention_incremental(
            q, cache["k"][li], cache["v"][li], positions, k, v,
            window=cfg.local_window)
        b = attn.shape[0]
        attn = maybe_flash_matmul(attn.reshape(b, 1, -1), lp["attn"]["wo"])
        x = x + attn
        x = x + _ffn_apply(cfg, lp["ffn"], _norm(cfg, x, lp, "ln2"))
        # rows >= kv_len are masked in every later read of this step
        cache["k"][li].index_copy_(1, positions, k.to(cache["k"].dtype))
        cache["v"][li].index_copy_(1, positions, v.to(cache["v"].dtype))
    x = _final_norm(cfg, params, x)
    return maybe_flash_matmul(x[:, 0], params["lm_head"],
                              out_dtype=torch.float32)


def decode_step(cfg, params, cache, batch):
    """One decode step. batch: {"token" (B,), "kv_len" host int: the filled
    prefix}. cache: {"k"/"v": (L, B, Smax, KV, Dh)}. Returns (logits (B, V)
    f32, cache).

    Each layer attends the cache's first kv_len rows plus the new token
    (merged analytically), then writes the new token's K/V row at kv_len
    IN PLACE: the returned cache is the dict passed in. The reference
    writes all layers' rows after its layer scan with a
    ``dynamic_update_slice``, which clamps an out-of-range start; here
    kv_len outside [0, Smax) raises. The host check (``decode_check``),
    then the body (``decode_body``) on kv_len as a device tensor.
    """
    kv_len = decode_check(cache, batch)
    token = batch["token"]
    pos = torch.full((1,), kv_len, dtype=torch.int64, device=token.device)
    return decode_body(cfg, params, cache, token, pos), cache


def cache_shape(cfg, batch: int, max_seq: int) -> dict:
    """The cache's shapes and dtype as meta tensors (no storage)."""
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.empty(kv, dtype=torch.bfloat16, device="meta"),
            "v": torch.empty(kv, dtype=torch.bfloat16, device="meta")}


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
