"""Encoder-decoder transformer backbone (seamless-m4t-medium) — the port of
``repro/models/encdec.py``'s inference and training paths: ``init``,
``encode``, ``forward``, ``train_loss``, ``prefill``, ``decode_step`` (a
host check and a device body, which ``launch.steps`` captures in a CUDA
graph) and ``cache_shape``.

The modality frontend is a stub, as in the reference: the caller hands
precomputed frame embeddings ``src_embeds`` (B, S_src, D). The backbone:

  encoder : n_enc_layers x [bidirectional self-attention + GELU FFN]
  decoder : n_layers x [causal self-attention + cross-attention over the
            encoder output + GELU FFN]

A decode step attends the self-KV cache (row kv_len and later unread, the
new token merged analytically: ``common.decode_attention_incremental``)
and the cross-KV at its full length (``common.decode_attention``); both
run the decode kernel on the card. The cross-KV is computed once, at
prefill. FFNs of both stacks and ``lm_head`` are flash-tier
(``core.erdpe.maybe_flash_matmul``). Cache: ``k``/``v`` (L, B, S_max, H,
Dh) and ``ck``/``cv`` (L, B, S_src, H, Dh), bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.dense import layer_slice

# the top-level params whose leaves carry a leading layer axis: the train
# step hands each layer's slice to the loss as its own autograd leaf
# (launch/steps.py)
STACKED = ("enc", "dec")


# --- init ------------------------------------------------------------------------

def _cross_init(cfg, gen, device):
    d, hd, bf = cfg.d_model, cfg.n_heads * cfg.head_dim, torch.bfloat16
    return {"wq": cm.dense_init(gen, d, hd, bf, device),
            "wk": cm.dense_init(gen, d, hd, bf, device),
            "wv": cm.dense_init(gen, d, hd, bf, device),
            "wo": cm.dense_init(gen, hd, d, bf, device)}


def init(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params with the JAX ``encdec.init``'s tree, shapes,
    distributions and scales, drawn on the generator's device one layer
    at a time."""
    d, bf = cfg.d_model, torch.bfloat16

    def zeros():
        return torch.zeros((d,), dtype=bf, device=device)

    def enc_layer(_):
        return {"ln1": zeros(),
                "attn": cm.attn_init(generator, dense.attn_cfg(cfg), bf,
                                     device),
                "ln2": zeros(),
                "ffn": cm.gelu_ffn_init(generator, d, cfg.d_ff, bf, device)}

    def dec_layer(_):
        return {"ln1": zeros(),
                "attn": cm.attn_init(generator, dense.attn_cfg(cfg), bf,
                                     device),
                "ln_x": zeros(),
                "cross": _cross_init(cfg, generator, device),
                "ln2": zeros(),
                "ffn": cm.gelu_ffn_init(generator, d, cfg.d_ff, bf, device)}

    return {"embed": cm.embed_init(generator, cfg.vocab_size, d, bf, device),
            "src_norm": zeros(),
            "enc": cm.stack_layers(cfg.n_enc_layers, enc_layer),
            "enc_norm": zeros(),
            "dec": cm.stack_layers(cfg.n_layers, dec_layer),
            "final_norm": zeros(),
            "lm_head": cm.dense_init(generator, d, cfg.vocab_size, bf,
                                     device)}


# --- encoder -----------------------------------------------------------------------

def encode(cfg, params, src_embeds, remat=True):
    """src_embeds (B, S_src, D) precomputed frame embeddings (the stub
    frontend) -> the encoder output (B, S_src, D) bf16. ``remat`` (while
    grad is enabled): each layer's activations are recomputed in the
    backward."""
    x = cm.rms_norm(src_embeds.to(torch.bfloat16), params["src_norm"])
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, li):
        x = cm.pin_batch(x)
        lp = cm.pin_layer_grads(layer_slice(params["enc"], li))
        h = cm.rms_norm(x, lp["ln1"])
        q, k, v = cm.qkv_project(lp["attn"], h, dense.attn_cfg(cfg),
                                 positions)
        attn = cm.chunked_attention(q, k, v, causal=False)
        x = x + maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
        return x + cm.gelu_ffn_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))

    for li in range(cfg.n_enc_layers):
        x = cm.remat(layer, x, li) if remat else layer(x, li)
    return cm.rms_norm(x, params["enc_norm"])


# --- decoder -----------------------------------------------------------------------

def _heads(cfg, t):
    return sh.split_last(t, cfg.n_heads)


def _cross_kv(cfg, p, enc_out):
    return (_heads(cfg, maybe_flash_matmul(enc_out, p["wk"])),
            _heads(cfg, maybe_flash_matmul(enc_out, p["wv"])))


def _cross_attend(cfg, p, x, enc_kv):
    """x (B, St, D); enc_kv (k, v), each (B, S_src, H, Dh)."""
    b, st = x.shape[:2]
    q = _heads(cfg, maybe_flash_matmul(x, p["wq"]))
    out = cm.chunked_attention(q, *enc_kv, causal=False)
    return maybe_flash_matmul(out.reshape(b, st, -1), p["wo"])


def _dec_layer(cfg, x, lp, enc_out, positions):
    x = cm.pin_batch(x)
    lp = cm.pin_layer_grads(lp)
    h = cm.rms_norm(x, lp["ln1"])
    q, k, v = cm.qkv_project(lp["attn"], h, dense.attn_cfg(cfg), positions)
    attn = cm.chunked_attention(q, k, v, causal=True)
    x = x + maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
    enc_kv = _cross_kv(cfg, lp["cross"], enc_out)
    x = x + _cross_attend(cfg, lp["cross"], cm.rms_norm(x, lp["ln_x"]),
                          enc_kv)
    x = x + cm.gelu_ffn_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))
    return x, (k, v) + enc_kv


def forward(cfg, params, src_embeds, tgt_tokens, remat=True,
            return_cache=False):
    """(src_embeds (B, S_src, D), tgt_tokens (B, St)) -> logits (B, St, V)
    f32, and with ``return_cache`` the self- and cross-KV caches.
    ``remat`` (while grad is enabled, without a cache): each encoder and
    decoder layer's activations are recomputed in the backward."""
    remat = remat and not return_cache
    enc_out = encode(cfg, params, src_embeds, remat=remat)
    positions = torch.arange(tgt_tokens.shape[1], device=tgt_tokens.device)
    x = cm.embed_rows(params["embed"], tgt_tokens)

    def layer(x, li):
        return _dec_layer(cfg, x, layer_slice(params["dec"], li), enc_out,
                          positions)[0]

    kvs = []
    for li in range(cfg.n_layers):
        if remat:
            x = cm.remat(layer, x, li)
            continue
        x, kv = _dec_layer(cfg, x, layer_slice(params["dec"], li), enc_out,
                           positions)
        if return_cache:
            kvs.append(kv)
    x = cm.rms_norm(x, params["final_norm"])
    logits = maybe_flash_matmul(x, params["lm_head"], out_dtype=torch.float32)
    if return_cache:
        ks, vs, cks, cvs = (torch.stack(t) for t in zip(*kvs))
        return logits, {"k": ks, "v": vs, "ck": cks, "cv": cvs}
    return logits


def train_loss(cfg, params, batch):
    """Mean next-token cross-entropy of batch {"src_embeds", "tgt_tokens",
    "labels"}."""
    logits = forward(cfg, params, batch["src_embeds"], batch["tgt_tokens"])
    return cm.softmax_xent(logits, batch["labels"])


def cache_shape(cfg, batch: int, max_seq: int,
                src_len: int | None = None) -> dict:
    """Self-KV at max_seq rows, cross-KV at src_len (max_seq // 8 where not
    given), as meta tensors."""
    ss = src_len if src_len is not None else max_seq // 8
    h, dh, n_l = cfg.n_heads, cfg.head_dim, cfg.n_layers

    def meta(s):
        return torch.empty((n_l, batch, s, h, dh), dtype=torch.bfloat16,
                           device="meta")
    return {"k": meta(max_seq), "v": meta(max_seq), "ck": meta(ss),
            "cv": meta(ss)}


def prefill(cfg, params, batch, pad_to: int | None = None):
    """batch: {"src_embeds" (B, S_src, D), "tgt_tokens" (B, St)}. Returns
    (last_logits (B, V), cache), the self-KV padded with zero rows to
    ``pad_to``."""
    logits, cache = forward(cfg, params, batch["src_embeds"],
                            batch["tgt_tokens"], return_cache=True)
    if pad_to is not None:
        s = cache["k"].shape[2]
        if pad_to < s:
            raise ValueError(f"prefill: pad_to {pad_to} < sequence {s}")
        pad = (0, 0, 0, 0, 0, pad_to - s)
        cache = {**cache, "k": F.pad(cache["k"], pad),
                 "v": F.pad(cache["v"], pad)}
    return logits[:, -1], cache


decode_check = dense.decode_check


def decode_body(cfg, params, cache, token, kv_len):
    """The device half of ``decode_step``: token (B,) int, kv_len a (1,)
    int64 device tensor (a checked one). Reads no tensor on the host, so
    ``launch.steps.make_decode_step(compiled=True)`` captures it. Returns
    the logits (B, V) f32; the self-KV row kv_len is written in place."""
    x = cm.embed_rows(params["embed"], token.long()[:, None])
    b = x.shape[0]
    for li in range(cfg.n_layers):
        lp = layer_slice(params["dec"], li)
        h = cm.rms_norm(x, lp["ln1"])
        q, k, v = cm.qkv_project(lp["attn"], h, dense.attn_cfg(cfg), kv_len)
        attn = cm.decode_attention_incremental(
            q, cache["k"][li], cache["v"][li], kv_len, k, v)
        x = x + maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
        # cross-attention against the fixed encoder KV, at its full length
        hx = cm.rms_norm(x, lp["ln_x"])
        qx = _heads(cfg, maybe_flash_matmul(hx, lp["cross"]["wq"]))
        ck, cv = cache["ck"][li], cache["cv"][li]
        xattn = cm.decode_attention(qx, ck, cv, ck.shape[1])
        x = x + maybe_flash_matmul(sh.merge_last(xattn),
                                   lp["cross"]["wo"])
        x = x + cm.gelu_ffn_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))
        # row kv_len is masked in every later read of this step
        sh.write_rows_(cache["k"][li], 1, kv_len, k.to(cache["k"].dtype))
        sh.write_rows_(cache["v"][li], 1, kv_len, v.to(cache["v"].dtype))
    x = cm.rms_norm(x, params["final_norm"])
    return maybe_flash_matmul(x[:, 0], params["lm_head"],
                              out_dtype=torch.float32)


def decode_step(cfg, params, cache, batch):
    """One decoder token. batch: {"token" (B,), "kv_len" host int: the
    filled prefix}. Returns (logits (B, V) f32, cache): the self-KV row
    kv_len is written IN PLACE (the reference's ``dynamic_update_slice``
    clamps a start past the cache; here kv_len outside [0, S_max)
    raises). The host check (``decode_check``), then the body
    (``decode_body``)."""
    kv_len = decode_check(cache, batch)
    token = batch["token"]
    pos = torch.full((1,), kv_len, dtype=torch.int64, device=token.device)
    return decode_body(cfg, params, cache, token, pos), cache
