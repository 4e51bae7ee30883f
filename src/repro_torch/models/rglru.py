"""RecurrentGemma / Griffin hybrid — the port of ``repro/models/rglru.py``'s
inference and training paths: RG-LRU recurrent blocks and local
attention, ``init``, ``forward``, ``train_loss``, ``prefill``,
``decode_step`` (a host check and a device body, which ``launch.steps``
captures in a CUDA graph) and ``cache_shape``.

The layers repeat (recurrent, recurrent, local attention), the 1:2 ratio
of arXiv:2402.19427; ``n_layers`` not a multiple of 3 ends with a tail of
recurrent layers (38 = 12 x 3 + 2). Params: ``blocks/{r1,r2,a}`` stacked
over the super-blocks, ``tail`` over the tail layers.

RG-LRU (per channel, diagonal gates):
    r_t = sigmoid(w_a * x_t + b_a),  i_t = sigmoid(w_x * x_t + b_x)
    log a_t = -c * softplus(lam) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Prefill runs the recurrence as a log-depth scan in f32 (the reference's
``jax.lax.associative_scan``; the two sum in different orders, so they
agree to f32 rounding), decode one step. The scan, the causal conv and
the windowed prefill attention are plain torch, as the reference computes
them outside any Pallas kernel. Attention keeps a ring-buffer KV cache of
``local_window`` rows (position p at slot p % window); a decode step
attends it through ``common.decode_attention``, the decode kernel on the
card. The recurrent block's in/out projections, the FFN (SwiGLU) and
``lm_head`` are flash-tier (``core.erdpe.maybe_flash_matmul``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.dense import layer_slice

RG_LRU_C = 8.0
# the cache entries a decode step advances (reads and rewrites; the ring's
# slot is only written): the step builder restores them after a capture's
# warm-up (launch/steps.py)
RECURRENT_STATE = ("conv1", "h1", "conv2", "h2", "conv_t", "h_t")
# the top-level params whose leaves carry a leading layer axis: the train
# step hands each layer's slice to the loss as its own autograd leaf
# (launch/steps.py)
STACKED = ("blocks", "tail")


# --- init -----------------------------------------------------------------------

def _rec_mix_init(cfg, gen, device):
    """Temporal-mixing (recurrent) block params."""
    d, r, bf = cfg.d_model, cfg.lru_width or cfg.d_model, torch.bfloat16

    def full(v, dtype=bf):
        return torch.full((r,), v, dtype=dtype, device=device)
    return {
        "w_in_x": cm.dense_init(gen, d, r, bf, device),   # recurrence branch
        "w_in_y": cm.dense_init(gen, d, r, bf, device),   # gate branch (GeLU)
        "conv_w": cm.normal_init(gen, (cfg.conv_width, r),
                                 1.0 / cfg.conv_width, device=device),
        "conv_b": full(0.0), "rg_a_w": full(0.0),
        "rg_a_b": full(1.0),                     # bias > 0: start remembering
        "rg_x_w": full(0.0), "rg_x_b": full(0.0),
        # a = exp(-8 softplus(lam)) spans about (0.9, 0.999)
        "lam": torch.linspace(-4.0, -1.0, r, dtype=torch.float32,
                              device=device),
        "w_out": cm.dense_init(gen, r, d, bf, device),
    }


def _rec_layer_init(cfg, gen, device):
    d, bf = cfg.d_model, torch.bfloat16
    return {"ln1": torch.zeros((d,), dtype=bf, device=device),
            "mix": _rec_mix_init(cfg, gen, device),
            "ln2": torch.zeros((d,), dtype=bf, device=device),
            "ffn": cm.swiglu_init(gen, d, cfg.d_ff, bf, device)}


def _attn_layer_init(cfg, gen, device):
    d, bf = cfg.d_model, torch.bfloat16
    return {"ln1": torch.zeros((d,), dtype=bf, device=device),
            "attn": cm.attn_init(gen, dense.attn_cfg(cfg), bf, device),
            "ln2": torch.zeros((d,), dtype=bf, device=device),
            "ffn": cm.swiglu_init(gen, d, cfg.d_ff, bf, device)}


def block_counts(cfg) -> tuple[int, int]:
    """(n_superblocks, n_tail_recurrent) covering cfg.n_layers."""
    return cfg.n_layers // 3, cfg.n_layers % 3


def init(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params with the JAX ``rglru.init``'s tree, shapes,
    distributions and scales, drawn on the generator's device one layer
    at a time."""
    n_super, n_tail = block_counts(cfg)
    bf = torch.bfloat16

    def superblock(_):
        return {"r1": _rec_layer_init(cfg, generator, device),
                "r2": _rec_layer_init(cfg, generator, device),
                "a": _attn_layer_init(cfg, generator, device)}

    params = {
        "embed": cm.embed_init(generator, cfg.vocab_size, cfg.d_model, bf,
                               device),
        "blocks": cm.stack_layers(n_super, superblock),
        "final_norm": torch.zeros((cfg.d_model,), dtype=bf, device=device),
        "lm_head": cm.dense_init(generator, cfg.d_model, cfg.vocab_size, bf,
                                 device),
    }
    if n_tail:
        params["tail"] = cm.stack_layers(
            n_tail, lambda _: _rec_layer_init(cfg, generator, device))
    return params


# --- RG-LRU core ------------------------------------------------------------------

def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, R), w (W, R) -> (B, S, R), f32 sums
    in the reference's order, rounded to x's dtype."""
    width, s = w.shape[0], x.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        shift = width - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        acc = acc + xi.float() * w[i].float()
    return (acc + b.float()).to(x.dtype)


def _rg_lru_gates(p, u):
    """u (..., R) conv output -> (log_a, beta * gated u), both f32."""
    uf = u.float()
    r = torch.sigmoid(uf * p["rg_a_w"].float() + p["rg_a_b"].float())
    i = torch.sigmoid(uf * p["rg_x_w"].float() + p["rg_x_b"].float())
    log_a = -RG_LRU_C * F.softplus(p["lam"].float()) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * uf


def rg_lru_seq(p, u):
    """Full-sequence RG-LRU from a zero state. u (B, S, R) -> (h in u's
    dtype, h_last f32). h_t = a_t h_{t-1} + b_t as a log-depth
    (Hillis-Steele) scan over the sequence: after the step at offset d,
    (a_t, b_t) composes the steps t - 2d + 1 .. t."""
    log_a, b = _rg_lru_gates(p, u)
    a = torch.exp(log_a)
    s, d = u.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b.to(u.dtype), b[:, -1]


def rg_lru_step(p, u, h_prev):
    """One decode step. u (B, 1, R); h_prev (B, R) f32."""
    log_a, b = _rg_lru_gates(p, u)
    h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
    return h.to(u.dtype)[:, None], h


def _gate_params(p):
    return {k: p[k] for k in ("conv_w", "conv_b", "rg_a_w", "rg_a_b",
                              "rg_x_w", "rg_x_b", "lam")}


def _conv_scan(u, p):
    """The causal conv, then the RG-LRU over the sequence."""
    return rg_lru_seq(p, _causal_conv(u, p["conv_w"], p["conv_b"]))


def _rec_mix_seq(p, x):
    """Recurrent temporal mix over a sequence from a zero state. Returns
    (out, (conv tail: the last W-1 rows of u, h_last))."""
    gate = F.gelu(maybe_flash_matmul(x, p["w_in_y"]).float(),
                  approximate="tanh")
    u = maybe_flash_matmul(x, p["w_in_x"])
    # over a mesh: on each rank's own rows (sharding.local_rows)
    h, h_last = sh.local_rows(_conv_scan, u, p=_gate_params(p))
    tail = u[:, -(p["conv_w"].shape[0] - 1):]
    out = maybe_flash_matmul((gate * h.float()).to(x.dtype), p["w_out"])
    return out, (tail, h_last)


def _rec_mix_step(p, x, conv_state, h_prev):
    """Decode step. x (B, 1, D); conv_state (B, W-1, R); h_prev (B, R) f32.
    Returns (out, (new conv state, h))."""
    gate = F.gelu(maybe_flash_matmul(x, p["w_in_y"]).float(),
                  approximate="tanh")
    u = maybe_flash_matmul(x, p["w_in_x"])                   # (B, 1, R)
    u_ext = torch.cat([conv_state.to(u.dtype), u], dim=1)    # (B, W, R)
    # the causal conv's last row in the reference's order: tap i reads row
    # n - W + i (none before the first: a prompt shorter than W - 1 left a
    # shorter state)
    width, n = p["conv_w"].shape[0], u_ext.shape[1]
    acc = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(max(0, width - n), width):
        j = n - width + i
        acc = acc + u_ext[:, j:j + 1].float() * p["conv_w"][i].float()
    c = (acc + p["conv_b"].float()).to(u.dtype)
    h, h_new = rg_lru_step(p, c, h_prev)
    out = maybe_flash_matmul((gate * h.float()).to(x.dtype), p["w_out"])
    return out, (u_ext[:, 1:], h_new)


# --- layers ------------------------------------------------------------------------

def _rec_layer_seq(cfg, x, lp):
    x = cm.pin_batch(x)
    lp = cm.pin_layer_grads(lp)
    mix, state = _rec_mix_seq(lp["mix"], cm.rms_norm(x, lp["ln1"]))
    x = x + mix
    x = x + cm.swiglu_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))
    return x, state


def _attn_layer_seq(cfg, x, lp, positions):
    x = cm.pin_batch(x)
    lp = cm.pin_layer_grads(lp)
    h = cm.rms_norm(x, lp["ln1"])
    q, k, v = cm.qkv_project(lp["attn"], h, dense.attn_cfg(cfg), positions)
    attn = cm.chunked_attention(q, k, v, causal=True,
                                window=cfg.local_window)
    x = x + maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
    x = x + cm.swiglu_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))
    return x, (k, v)


# --- model API -----------------------------------------------------------------------

def forward(cfg, params, tokens, remat=True, return_cache=False):
    """tokens (B, S) -> logits (B, S, V) f32, and with ``return_cache`` the
    cache after the last token (``_pack_cache``). ``remat`` (while grad is
    enabled, without a cache): each (r, r, a) super-block's and each tail
    layer's activations are recomputed in the backward, as the
    reference's checkpointed scan bodies."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = cm.embed_rows(params["embed"], tokens)
    n_super, n_tail = block_counts(cfg)

    def superblock(x, i):
        bp = layer_slice(params["blocks"], i)
        x, a = _rec_layer_seq(cfg, x, bp["r1"])
        x, b = _rec_layer_seq(cfg, x, bp["r2"])
        x, c = _attn_layer_seq(cfg, x, bp["a"], positions)
        return x, (a, b, c)

    def tail_layer(x, j):
        return _rec_layer_seq(cfg, x, layer_slice(params["tail"], j))

    remat = remat and not return_cache
    st1, st2, kv, tail = [], [], [], []
    for i in range(n_super):
        if remat:
            x = cm.remat(lambda x, i: superblock(x, i)[0], x, i)
            continue
        x, (a, b, c) = superblock(x, i)
        if return_cache:
            st1.append(a)
            st2.append(b)
            kv.append(c)
    for j in range(n_tail):
        if remat:
            x = cm.remat(lambda x, j: tail_layer(x, j)[0], x, j)
            continue
        x, st = tail_layer(x, j)
        if return_cache:
            tail.append(st)
    x = cm.rms_norm(x, params["final_norm"])
    logits = maybe_flash_matmul(x, params["lm_head"], out_dtype=torch.float32)
    if not return_cache:
        return logits

    def stacked(states):
        return tuple(torch.stack(t) for t in zip(*states))
    return logits, _pack_cache(cfg, (stacked(st1), stacked(st2)),
                               stacked(kv), stacked(tail) if n_tail else None,
                               s)


def train_loss(cfg, params, batch):
    """Mean next-token cross-entropy of batch {"tokens", "labels"},
    through ``rg_lru_seq`` and the local-window attention layers."""
    logits = forward(cfg, params, batch["tokens"], remat=True)
    return cm.softmax_xent(logits, batch["labels"])


# --- cache layout ----------------------------------------------------------------------
# recurrent states per stack: conv (N, B, W-1, R) bf16, h (N, B, R) f32;
# attention: a ring KV (N_super, B, window, KV, Dh); kv_len kept by the caller

def _ring_from_prefill(cfg, k, v, s):
    """Prefill K/V (N, B, S, KV, Dh) -> ring caches (N, B, W, KV, Dh),
    position p at slot p % window."""
    w = cfg.local_window

    def ring(t):
        if s >= w:
            return torch.roll(t[:, :, -w:], s % w, dims=2)
        return F.pad(t, (0, 0, 0, 0, 0, w - s))
    # over a mesh: on each rank's shards, the sequence whole
    return sh.along(ring, k, 2), sh.along(ring, v, 2)


def _pack_cache(cfg, rec_states, kv, tail_states, s):
    (c1, h1), (c2, h2) = rec_states
    rk, rv = _ring_from_prefill(cfg, *kv, s)
    cache = {"conv1": c1, "h1": h1, "conv2": c2, "h2": h2, "k": rk, "v": rv}
    if tail_states is not None:
        cache["conv_t"], cache["h_t"] = tail_states
    return cache


def cache_shape(cfg, batch: int, max_seq: int) -> dict:
    """The cache's shapes and dtypes as meta tensors; the attention cache is
    O(window) whatever the context length ``max_seq``."""
    n_super, n_tail = block_counts(cfg)
    r = cfg.lru_width or cfg.d_model
    wm1, w = cfg.conv_width - 1, cfg.local_window

    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    kv = (n_super, batch, w, cfg.n_kv_heads, cfg.head_dim)
    out = {"conv1": meta((n_super, batch, wm1, r)),
           "h1": meta((n_super, batch, r), torch.float32),
           "conv2": meta((n_super, batch, wm1, r)),
           "h2": meta((n_super, batch, r), torch.float32),
           "k": meta(kv), "v": meta(kv)}
    if n_tail:
        out["conv_t"] = meta((n_tail, batch, wm1, r))
        out["h_t"] = meta((n_tail, batch, r), torch.float32)
    return out


def prefill(cfg, params, batch, pad_to: int | None = None):
    """(last_logits (B, V), cache); ``pad_to`` is a no-op (the ring cache
    is fixed-size)."""
    del pad_to
    logits, cache = forward(cfg, params, batch["tokens"], return_cache=True)
    return logits[:, -1], cache


def _rec_step_layer(cfg, x, lp, conv, h, li):
    """A recurrent layer's decode step; writes conv[li] and h[li] in
    place."""
    mix, (conv_new, h_new) = _rec_mix_step(
        lp["mix"], cm.rms_norm(x, lp["ln1"]), conv[li], h[li])
    x = x + mix
    x = x + cm.swiglu_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))
    conv[li].copy_(conv_new)
    h[li].copy_(h_new)
    return x


def _ring_attention_step(cfg, lp, x, k_cache, v_cache, kv_len):
    """Decode attention against one layer's ring cache, x (B, 1, D);
    kv_len (1,) int64 on the device. The new K/V row is written at slot
    kv_len % window first, in place; the first min(kv_len + 1, window)
    slots are live."""
    h = cm.rms_norm(x, lp["ln1"])
    q, k, v = cm.qkv_project(lp["attn"], h, dense.attn_cfg(cfg), kv_len)
    w = cfg.local_window
    slot = torch.remainder(kv_len, w)
    sh.write_rows_(k_cache, 1, slot, k.to(k_cache.dtype))
    sh.write_rows_(v_cache, 1, slot, v.to(v_cache.dtype))
    attn = cm.decode_attention(q, k_cache, v_cache,
                               torch.clamp_max(kv_len + 1, w))
    x = x + maybe_flash_matmul(sh.merge_last(attn), lp["attn"]["wo"])
    return x + cm.swiglu_apply(lp["ffn"], cm.rms_norm(x, lp["ln2"]))


def decode_check(cache, batch) -> int:
    """The host half of ``decode_step``: batch["kv_len"] as an int, which
    must not be negative (the ring takes any position past it)."""
    kv_len = int(batch["kv_len"])
    if kv_len < 0:
        raise ValueError(f"decode_step: kv_len {kv_len} < 0")
    return kv_len


def decode_body(cfg, params, cache, token, kv_len):
    """The device half of ``decode_step``: token (B,) int, kv_len a (1,)
    int64 device tensor (a checked one). The ring slot and the live count
    come from it on the device, so one capture
    (``launch.steps.make_decode_step(compiled=True)``) serves every step,
    the wrap past the window included. Returns the logits (B, V) f32;
    every cache tensor is written in place."""
    x = cm.embed_rows(params["embed"], token.long()[:, None])
    n_super, n_tail = block_counts(cfg)
    for i in range(n_super):
        bp = layer_slice(params["blocks"], i)
        x = _rec_step_layer(cfg, x, bp["r1"], cache["conv1"], cache["h1"], i)
        x = _rec_step_layer(cfg, x, bp["r2"], cache["conv2"], cache["h2"], i)
        x = _ring_attention_step(cfg, bp["a"], x, cache["k"][i],
                                 cache["v"][i], kv_len)
    for j in range(n_tail):
        x = _rec_step_layer(cfg, x, layer_slice(params["tail"], j),
                            cache["conv_t"], cache["h_t"], j)
    x = cm.rms_norm(x, params["final_norm"])
    return maybe_flash_matmul(x[:, 0], params["lm_head"],
                              out_dtype=torch.float32)


def decode_step(cfg, params, cache, batch):
    """One decode step. batch: {"token" (B,), "kv_len" host int: the
    tokens seen so far}. Returns (logits (B, V) f32, cache), the cache
    written IN PLACE (the returned cache is the dict passed in). The host
    check (``decode_check``), then the body (``decode_body``)."""
    kv_len = decode_check(cache, batch)
    token = batch["token"]
    pos = torch.full((1,), kv_len, dtype=torch.int64, device=token.device)
    return decode_body(cfg, params, cache, token, pos), cache
