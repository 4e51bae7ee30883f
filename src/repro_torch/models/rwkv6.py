"""RWKV-6 "Finch" (arXiv:2404.05892) — the port of ``repro/models/rwkv6.py``'s
inference and training paths: ``init``, ``forward``, ``train_loss``,
``prefill``, ``decode_step`` (a host check and a device body, which
``launch.steps`` captures in a CUDA graph) and ``cache_shape``.

Time mixing (per head, head_dim K):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state S in R^{KxV})
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with per-channel, data-dependent decay w_t = exp(-exp(d_t)) and the Finch
data-dependent token-shift lerp. Two wkv forms, equal to f32 rounding:
``wkv_scan`` (one step a token; decode) and ``wkv_chunked`` (the
reference's blocked two-level scan; prefill). Both run in plain torch in
f32, as the reference computes them outside any Pallas kernel; so do the
decay LoRA's products, which are f32 (they run in full f32 on the card
while ``torch.backends.cuda.matmul.allow_tf32`` is off, its default).

Every time-mix projection (``w_r/k/v/g/o``) and the channel mix's
``w_up``, ``w_down``, ``w_rgate`` and ``lm_head`` are flash-tier and go
through ``core.erdpe.maybe_flash_matmul``: the ECDP on the card. The model
is attention-free; its state is O(1) in the context length. Params are
nested dicts with the reference's names, per-layer weights stacked along a
leading (L,) dim. Cache: ``tmix_x``/``cmix_x`` (L, B, D) bf16, ``wkv``
(L, B, H, K, K) f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm
from repro_torch.models.dense import layer_slice

# the cache entries a decode step advances (reads and rewrites): the step
# builder restores them after a capture's warm-up (launch/steps.py)
RECURRENT_STATE = ("tmix_x", "wkv", "cmix_x")
# the top-level params whose leaves carry a leading layer axis: the train
# step hands each layer's slice to the loss as its own autograd leaf
# (launch/steps.py)
STACKED = ("layers",)
TS_LORA = 32      # token-shift LoRA rank
DEC_LORA = 64     # decay LoRA rank
DEFAULT_CHUNK = 64


# --- init ---------------------------------------------------------------------

def _tmix_init(cfg, gen, device):
    d, bf = cfg.d_model, torch.bfloat16
    p = {"mu_x": torch.full((d,), 0.5, dtype=bf, device=device),
         "mu": torch.full((5, d), 0.5, dtype=bf, device=device),
         "ts_A": cm.dense_init(gen, d, 5 * TS_LORA, bf, device),
         "ts_B": cm.normal_init(gen, (5, TS_LORA, d), 0.01, device=device)}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = cm.dense_init(gen, d, d, bf, device)
    # decay: log w = -exp(dec); dec ~ N(-1.5, 0.3^2) -> w ~ 0.8
    p["dec_base"] = cm.normal_init(gen, (d,), 0.3, -1.5, torch.float32,
                                   device)
    p["dec_A"] = cm.dense_init(gen, d, DEC_LORA, bf, device)
    p["dec_B"] = cm.normal_init(gen, (DEC_LORA, d), 0.01, device=device)
    p["u"] = torch.full((d,), 0.5, dtype=torch.float32, device=device)
    p["gn_scale"] = torch.ones((d,), dtype=bf, device=device)
    p["gn_bias"] = torch.zeros((d,), dtype=bf, device=device)
    return p


def _cmix_init(cfg, gen, device):
    d, f, bf = cfg.d_model, cfg.d_ff, torch.bfloat16
    return {"mu_k": torch.full((d,), 0.5, dtype=bf, device=device),
            "mu_r": torch.full((d,), 0.5, dtype=bf, device=device),
            "w_up": cm.dense_init(gen, d, f, bf, device),
            "w_down": cm.dense_init(gen, f, d, bf, device),
            "w_rgate": cm.dense_init(gen, d, d, bf, device)}


def init(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params with the JAX ``rwkv6.init``'s tree, shapes,
    distributions and scales, drawn on the generator's device one layer
    at a time."""
    d, bf = cfg.d_model, torch.bfloat16

    def layer(_):
        return {"ln1": torch.zeros((d,), dtype=bf, device=device),
                "tmix": _tmix_init(cfg, generator, device),
                "ln2": torch.zeros((d,), dtype=bf, device=device),
                "channel_mix": _cmix_init(cfg, generator, device)}

    return {"embed": cm.embed_init(generator, cfg.vocab_size, d, bf, device),
            "ln_in": torch.zeros((d,), dtype=bf, device=device),
            "layers": cm.stack_layers(cfg.n_layers, layer),
            "final_norm": torch.zeros((d,), dtype=bf, device=device),
            "lm_head": cm.dense_init(generator, d, cfg.vocab_size, bf,
                                     device)}


# --- token shift ----------------------------------------------------------------

def _shift(x, x_last=None):
    """x_{t-1} along seq; the first row is x_last (decode carry) or 0."""
    pad = (torch.zeros_like(x[:, :1]) if x_last is None
           else x_last[:, None].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, xp):
    """Finch data-dependent lerp -> (xr, xk, xv, xw, xg), each (B, S, D)."""
    base = x + (xp - x) * p["mu_x"].to(x.dtype)
    z = torch.tanh(base.float() @ p["ts_A"].float())
    b, s, _ = x.shape
    z = z.reshape(b, s, 5, TS_LORA)
    m = p["mu"].float() + torch.einsum("bsfj,fjd->bsfd", z,
                                       p["ts_B"].float())
    xf, xpf = x.float(), xp.float()
    mixed = xf[:, :, None] + (xpf - xf)[:, :, None] * m      # (B, S, 5, D)
    return tuple(mixed[:, :, i].to(x.dtype) for i in range(5))


# --- wkv ------------------------------------------------------------------------

def wkv_scan(r, k, v, logw, u, s0):
    """Per-token recurrence. r/k/v/logw (B, S, H, K) f32; u (H, K); s0
    (B, H, K, V) f32. Returns (o (B, S, H, V), s_last)."""
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, logw, u, s0, chunk=DEFAULT_CHUNK):
    """The reference's blocked two-level scan; equals ``wkv_scan`` to f32
    rounding. Phase 1 advances every chunk of C steps at once from a zero
    state; phase 2 stitches the chunks' boundary states; only decaying
    exponentials (exp of non-positive sums) appear, so no decay
    overflows."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:   # zero k/v and log w: the padded steps leave the state as is
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = (s + pad) // c

    def chunked(t):                     # (B, S, H, X) -> (C, B, nc, H, X)
        return t.reshape(b, nc, c, h, -1).movedim(2, 0)

    rc, kc, vc, lwc = chunked(r), chunked(k), chunked(v), chunked(logw)
    # phase 1: intra-chunk, all chunks in parallel from a zero state
    sblk = torch.zeros((b, nc, h, kk, vv), dtype=torch.float32,
                       device=r.device)
    o_intra = []
    for t in range(c):
        kv = kc[t][..., None] * vc[t][..., None, :]          # (B,nc,H,K,V)
        o_intra.append(torch.einsum("bnhk,bnhkv->bnhv", rc[t],
                                    sblk + u[None, None, :, :, None] * kv))
        sblk = torch.exp(lwc[t])[..., None] * sblk + kv
    o_intra = torch.stack(o_intra)                           # (C,B,nc,H,V)
    # phase 2: inter-chunk, the state at each chunk's entry
    wc_total = torch.exp(lwc.sum(dim=0))                     # (B, nc, H, K)
    s_in, entry = s0, []
    for n in range(nc):
        entry.append(s_in)
        s_in = wc_total[:, n][..., None] * s_in + sblk[:, n]
    s0_chunks = torch.stack(entry, dim=1)                    # (B,nc,H,K,V)
    lw_cum = torch.cumsum(lwc, dim=0) - lwc                  # exclusive
    r_dec = rc * torch.exp(lw_cum)
    o_inter = torch.einsum("cbnhk,bnhkv->cbnhv", r_dec, s0_chunks)
    o = (o_intra + o_inter).movedim(0, 2).reshape(b, nc * c, h, vv)[:, :s]
    return o, s_in


# --- layers -----------------------------------------------------------------------

def _group_norm_heads(o, scale, bias, eps=64e-5):
    """Per-head LayerNorm over K (RWKV ln_x). o (B, S, H, K) f32 -> f32."""
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    y = (o - mu) * torch.rsqrt(var + eps)
    h, k = o.shape[-2:]
    return y * scale.float().reshape(h, k) + bias.float().reshape(h, k)


def tmix_seq(cfg, p, x, x_last=None, s0=None, wkv_mode="chunked"):
    """Time mix. x (B, S, D) -> (out, (x_last_new, s_last))."""
    b, s, d = x.shape
    kk = cfg.rwkv_head_dim
    h = d // kk
    xp = _shift(x, x_last)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xp)
    r = sh.split_last(maybe_flash_matmul(xr, p["w_r"]).float(), h)
    k = sh.split_last(maybe_flash_matmul(xk, p["w_k"]).float(), h)
    v = sh.split_last(maybe_flash_matmul(xv, p["w_v"]).float(), h)
    g = maybe_flash_matmul(xg, p["w_g"]).float()
    dec = p["dec_base"].float() + (
        torch.tanh(xw.float() @ p["dec_A"].float()) @ p["dec_B"].float())
    logw = -sh.split_last(torch.exp(dec), h)                 # <= 0
    u = p["u"].float().reshape(h, kk)
    if s0 is None:
        s0 = torch.zeros((b, h, kk, kk), dtype=torch.float32,
                         device=x.device)
    wkv = wkv_scan if wkv_mode == "scan" else wkv_chunked
    # over a mesh: on each rank's own rows (sharding.local_rows)
    o, s_last = sh.local_rows(lambda *t, u: wkv(*t[:4], u, t[4]),
                              r, k, v, logw, s0, u=u)
    o = sh.merge_last(_group_norm_heads(o, p["gn_scale"], p["gn_bias"]))
    o = (o * F.silu(g)).to(x.dtype)
    return maybe_flash_matmul(o, p["w_o"]), (x[:, -1], s_last)


def cmix_seq(p, x, x_last=None):
    """Channel mix (the FFN). x (B, S, D) -> (out, x_last_new)."""
    xp = _shift(x, x_last)
    xk = x + (xp - x) * p["mu_k"].to(x.dtype)
    xr = x + (xp - x) * p["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(maybe_flash_matmul(xk, p["w_up"]).float()))
    rr = torch.sigmoid(maybe_flash_matmul(xr, p["w_rgate"]).float())
    out = rr * maybe_flash_matmul(kk.to(x.dtype), p["w_down"]).float()
    return out.to(x.dtype), x[:, -1]


def _layer(cfg, x, lp, wkv_mode, tx=None, ts=None, cx=None):
    """One layer; returns (x, (tmix carry, wkv state, cmix carry))."""
    x = cm.pin_batch(x)
    lp = cm.pin_layer_grads(lp)
    mix, (tx, ts) = tmix_seq(cfg, lp["tmix"], cm.rms_norm(x, lp["ln1"]),
                             x_last=tx, s0=ts, wkv_mode=wkv_mode)
    x = x + mix
    cmx, cx = cmix_seq(lp["channel_mix"], cm.rms_norm(x, lp["ln2"]),
                       x_last=cx)
    return x + cmx, (tx, ts, cx)


# --- model API ---------------------------------------------------------------------

def forward(cfg, params, tokens, remat=True, return_cache=False,
            wkv_mode="chunked"):
    """tokens (B, S) -> logits (B, S, V) f32, and with ``return_cache`` the
    state after the last token. ``remat`` (while grad is enabled, without
    a cache): each layer's activations are recomputed in the backward."""
    x = cm.rms_norm(cm.embed_rows(params["embed"], tokens), params["ln_in"])

    def layer(x, li):
        return _layer(cfg, x, layer_slice(params["layers"], li), wkv_mode)[0]

    states = []
    for li in range(cfg.n_layers):
        if remat and not return_cache:
            x = cm.remat(layer, x, li)
            continue
        x, st = _layer(cfg, x, layer_slice(params["layers"], li), wkv_mode)
        if return_cache:
            states.append(st)
    x = cm.rms_norm(x, params["final_norm"])
    logits = maybe_flash_matmul(x, params["lm_head"], out_dtype=torch.float32)
    if return_cache:
        tx, ts, cx = (torch.stack(t) for t in zip(*states))
        return logits, {"tmix_x": tx, "wkv": ts, "cmix_x": cx}
    return logits


def train_loss(cfg, params, batch, wkv_mode="chunked"):
    """Mean next-token cross-entropy of batch {"tokens", "labels"}, the
    time mix through ``wkv_chunked`` (or ``wkv_scan``)."""
    logits = forward(cfg, params, batch["tokens"], remat=True,
                     wkv_mode=wkv_mode)
    return cm.softmax_xent(logits, batch["labels"])


def cache_shape(cfg, batch: int, max_seq: int) -> dict:
    """The state's shapes and dtypes as meta tensors: O(1) in the context
    length (``max_seq`` unused)."""
    d, kk, n_l = cfg.d_model, cfg.rwkv_head_dim, cfg.n_layers
    h = d // kk

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"tmix_x": meta((n_l, batch, d), torch.bfloat16),
            "wkv": meta((n_l, batch, h, kk, kk), torch.float32),
            "cmix_x": meta((n_l, batch, d), torch.bfloat16)}


def prefill(cfg, params, batch, pad_to: int | None = None,
            wkv_mode="chunked"):
    """(last_logits (B, V), cache); ``pad_to`` is a no-op (O(1) state)."""
    del pad_to
    logits, cache = forward(cfg, params, batch["tokens"], return_cache=True,
                            wkv_mode=wkv_mode)
    return logits[:, -1], cache


def decode_check(cache, batch) -> int:
    """The host half of ``decode_step``: the state has no length, so only
    batch["kv_len"] (0 where absent) as an int, for the step builder."""
    return int(batch.get("kv_len", 0))


def decode_body(cfg, params, cache, token, kv_len):
    """The device half of ``decode_step``: token (B,) int; ``kv_len`` is
    unused (the state is O(1)). Reads no tensor on the host, so
    ``launch.steps.make_decode_step(compiled=True)`` captures it. Returns
    the logits (B, V) f32; the state is written in place."""
    del kv_len
    x = cm.rms_norm(cm.embed_rows(params["embed"], token.long()[:, None]),
                    params["ln_in"])
    bf = torch.bfloat16
    for li in range(cfg.n_layers):
        x, (tx, ts, cx) = _layer(cfg, x, layer_slice(params["layers"], li),
                                 "scan", tx=cache["tmix_x"][li].to(bf),
                                 ts=cache["wkv"][li],
                                 cx=cache["cmix_x"][li].to(bf))
        cache["tmix_x"][li].copy_(tx)
        cache["wkv"][li].copy_(ts)
        cache["cmix_x"][li].copy_(cx)
    x = cm.rms_norm(x, params["final_norm"])
    return maybe_flash_matmul(x[:, 0], params["lm_head"],
                              out_dtype=torch.float32)


def decode_step(cfg, params, cache, batch):
    """One decode step. batch: {"token" (B,)[, "kv_len"]}. Returns (logits
    (B, V) f32, cache): the state is advanced IN PLACE, the returned cache
    is the dict passed in. The host check (``decode_check``), then the
    body (``decode_body``)."""
    kv_len = decode_check(cache, batch)
    token = batch["token"]
    pos = torch.full((1,), kv_len, dtype=torch.int64, device=token.device)
    return decode_body(cfg, params, cache, token, pos), cache
