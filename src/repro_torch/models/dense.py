"""Dense decoder-only transformer family — the port of
``repro/models/dense.py``: the norm and FFN dispatch, ``attn_cfg``, an
``init`` of the port's own, and the offline inference API — ``forward``,
``prefill``, ``decode_step`` (a host check and a device body, which
``launch.steps`` captures in a CUDA graph), ``cache_shape`` — and
training's ``train_loss`` over a rematerialized ``forward``. The layer
bodies take the FFN as a hook (``dense_ffn``), which the MoE family
replaces with its expert FFN.

Params are plain nested dicts of tensors with the JAX package's names and
layout: per-layer weights (bf16 tensors or stacked ``FlashWeight``s) are
stacked along a leading (L,) dim and indexed in a Python layer loop —
there is no scan (``layer_slice`` also takes a list of per-layer
tensors in a stacked tensor's place: the train step's per-layer leaves). Cache layout: K/V (L, B, S, KV, Dh).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm

# the top-level params whose leaves carry a leading layer axis: the train
# step hands each layer's slice to the loss as its own autograd leaf
# (launch/steps.py)
STACKED = ("layers",)


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


def _ffn_apply(cfg, p, x, partial: bool = False):
    """``partial``: one tensor-parallel shard's f32 partial of the FFN
    (``models.common.swiglu_apply``)."""
    if cfg.ffn_type == "swiglu":
        return cm.swiglu_apply(p, x, partial)
    return cm.gelu_ffn_apply(p, x, partial)


def dense_ffn(cfg, lp, h):
    """A layer's FFN on its normed input: the family's hook into the layer
    bodies below (``models/moe.py`` passes its expert FFN)."""
    return _ffn_apply(cfg, lp["ffn"], h)


def layer_slice(tree, li):
    """Layer ``li`` of a stacked param tree (views, no copies); a stacked
    leaf may also be a list of per-layer tensors."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, li) for k, v in tree.items()}
    return tree[li]


def _final_norm(cfg, params, x):
    if cfg.norm_type == "rms":
        return cm.rms_norm(x, params["final_norm"])
    return cm.layer_norm(x, params["final_norm"]["g"],
                         params["final_norm"]["b"])


def _layer_fwd(cfg, x, lp, positions, collect_kv=True, ffn=dense_ffn):
    """Full-sequence layer forward; returns (x, (k, v) or None)."""
    x = cm.pin_batch(x)
    lp = cm.pin_layer_grads(lp)
    h = _norm(cfg, x, lp, "ln1")
    q, k, v = cm.qkv_project(lp["attn"], h, attn_cfg(cfg), positions)
    attn = cm.chunked_attention(q, k, v, causal=True, window=cfg.local_window)
    attn = maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
    x = x + attn
    x = x + ffn(cfg, lp, _norm(cfg, x, lp, "ln2"))
    return x, ((k, v) if collect_kv else None)


def _embed(cfg, params, tokens, positions, extra_embeds=None):
    x = cm.embed_rows(params["embed"], tokens)
    if not cfg.use_rope and "pos_embed" in params:
        x = x + cm.embed_rows(params["pos_embed"], positions)
    if extra_embeds is not None:  # VLM: prepend patch embeddings (stub frontend)
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def forward(cfg, params, tokens, extra_embeds=None, remat=True,
            return_cache=False, ffn=dense_ffn):
    """Train / prefill forward. tokens (B, S) -> logits (B, S_tot, V) f32,
    and with ``return_cache`` the cache {"k"/"v": (L, B, S_tot, KV, Dh)}.
    ``ffn`` is each layer's FFN (``dense_ffn``'s signature).

    ``remat`` (while grad is enabled, ``common.remat``): each layer's
    activations are recomputed in the backward; with ``cfg.remat_groups``
    G > 1 dividing L (and no cache), sqrt-remat: G groups of L/G layers,
    each group itself rematerialized, so the stash is about G + L/G layer
    inputs, not L."""
    b, s = tokens.shape
    n_extra = extra_embeds.shape[1] if extra_embeds is not None else 0
    positions = torch.arange(s + n_extra, device=tokens.device)
    x = _embed(cfg, params, tokens, positions[n_extra:], extra_embeds)

    def layer(x, li):
        return _layer_fwd(cfg, x, layer_slice(params["layers"], li),
                          positions, collect_kv=False, ffn=ffn)[0]

    ks, vs = [], []
    g, n_l = cfg.remat_groups, cfg.n_layers
    if remat and not return_cache and g > 1 and n_l % g == 0:
        def group(x, first):
            for li in range(first, first + n_l // g):
                x = cm.remat(layer, x, li)
            return x
        for first in range(0, n_l, n_l // g):
            x = cm.remat(group, x, first)
    elif remat and not return_cache:
        for li in range(n_l):
            x = cm.remat(layer, x, li)
    else:
        for li in range(n_l):
            x, kv = _layer_fwd(cfg, x, layer_slice(params["layers"], li),
                               positions, collect_kv=return_cache, ffn=ffn)
            if return_cache:
                ks.append(kv[0])
                vs.append(kv[1])
    x = _final_norm(cfg, params, x)
    logits = maybe_flash_matmul(x, params["lm_head"], out_dtype=torch.float32)
    if return_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits


def train_loss(cfg, params, batch, ffn=dense_ffn):
    """Mean next-token cross-entropy of batch {"tokens", "labels" (B, S)[,
    "patch_embeds" (B, P, D)]}; the patch frontend's P positions are
    dropped from the logits before the loss. Layers rematerialized."""
    extra = batch.get("patch_embeds")
    logits = forward(cfg, params, batch["tokens"], extra_embeds=extra,
                     remat=True, ffn=ffn)
    n_extra = extra.shape[1] if extra is not None else 0
    return cm.softmax_xent(logits[:, n_extra:], batch["labels"])


def prefill(cfg, params, batch, pad_to: int | None = None, ffn=dense_ffn):
    """Returns (last_logits (B, V), cache). batch: {"tokens" (B, S)[,
    "patch_embeds"]}. Cache padded with zero rows to ``pad_to``."""
    extra = batch.get("patch_embeds")
    logits, cache = forward(cfg, params, batch["tokens"], extra_embeds=extra,
                            return_cache=True, ffn=ffn)
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


def decode_body(cfg, params, cache, token, kv_len, ffn=dense_ffn):
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
        attn = maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
        x = x + attn
        x = x + ffn(cfg, lp, _norm(cfg, x, lp, "ln2"))
        # rows >= kv_len are masked in every later read of this step
        sh.write_rows_(cache["k"][li], 1, positions,
                       k.to(cache["k"].dtype))
        sh.write_rows_(cache["v"][li], 1, positions,
                       v.to(cache["v"].dtype))
    x = _final_norm(cfg, params, x)
    return maybe_flash_matmul(x[:, 0], params["lm_head"],
                              out_dtype=torch.float32)


def decode_step(cfg, params, cache, batch, ffn=dense_ffn):
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
    return decode_body(cfg, params, cache, token, pos, ffn=ffn), cache


def cache_shape(cfg, batch: int, max_seq: int) -> dict:
    """The cache's shapes and dtype as meta tensors (no storage)."""
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.empty(kv, dtype=torch.bfloat16, device="meta"),
            "v": torch.empty(kv, dtype=torch.bfloat16, device="meta")}


def init_stack(generator: torch.Generator, lead: tuple, k: int, n: int,
               device, sink=None):
    """A (*lead, K, N) bf16 stack of ``common.dense_init`` matrices, drawn
    one (K, N) matrix at a time. With ``sink`` (a ``tiering.FlashEncoder``
    of that shape) each matrix goes to ``sink.put`` as it is drawn and the
    encoded ``FlashWeight`` is returned: the bf16 stack is never made."""
    if sink is None:
        w = torch.empty(lead + (k, n), dtype=torch.bfloat16, device=device)
        put = w.view((-1, k, n)).__setitem__
    else:
        put = sink.put
    for i in range(math.prod(lead)):
        put(i, cm.dense_init(generator, k, n, torch.bfloat16, device))
    return w if sink is None else sink.finish()


def init(cfg, generator: torch.Generator, device="cuda",
         ffn: bool = True, sink=None) -> dict:
    """Random params with the shapes, distributions and scales of the JAX
    ``dense.init`` (bf16; dense_init / embed_init scales; LayerNorm gains 1
    and biases 0, RMSNorm gammas 0, qk-norm gammas 0 too). Numbers are
    drawn on the generator's device and placed on ``device`` one (K, N)
    matrix at a time, so no full-model f32 temporary exists. ``ffn=False``
    leaves the FFN out (the MoE family draws its expert banks itself).
    This is the one home of the draw order. ``sink(path, shape)`` (from
    ``tiering.deploy_init``) may return a ``FlashEncoder`` for a matrix
    stack: its leaf is then encoded as drawn (``init_stack``)."""
    bf = torch.bfloat16
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    n_l = cfg.n_layers

    def stack(path, lead, k, n):
        return init_stack(generator, lead, k, n, device,
                          None if sink is None else sink(path, lead + (k, n)))

    mats = {"attn": {"wq": (d, h * dh), "wk": (d, kv * dh),
                     "wv": (d, kv * dh), "wo": (h * dh, d)}}
    if ffn:
        mats["ffn"] = ({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
                       if cfg.ffn_type == "swiglu"
                       else {"w_up": (d, f), "w_down": (f, d)})
    layers: dict = {}
    for group, shapes in mats.items():
        layers[group] = {name: stack(f"layers/{group}/{name}", (n_l,), k, n)
                         for name, (k, n) in shapes.items()}
    if cfg.qk_norm:                      # per-head RMSNorm gammas, zeros
        for name in ("q_norm", "k_norm"):
            layers["attn"][name] = torch.zeros((n_l, dh), dtype=bf,
                                               device=device)
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
        "lm_head": stack("lm_head", (), d, cfg.vocab_size),
    }
    if not cfg.use_rope:  # OPT-style learned positions
        params["pos_embed"] = cm.embed_init(generator, cfg.max_seq, d, bf,
                                            device)
    return params
