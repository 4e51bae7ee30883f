"""Shared functional layers — the port of the parts of
``repro/models/common.py`` the serving and offline paths use.

Plain functions over tensors and dicts of tensors. bf16 contractions are
written as f32 ops on upcast operands: a bf16 value is exact in f32, so
this is the reference's "bf16 operands, f32 accumulation" with an explicit
dtype on both sides; results are rounded to bf16 where the reference
rounds. FFN matmuls route through ``core.erdpe.maybe_flash_matmul``, so
the same code serves bf16 params and flash-tier (INT8+ECC) params.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import maybe_flash_matmul
from repro_torch.kernels.decode_attn import (decode_attention_state,
                                             decode_attention_state_plain,
                                             decode_attn,
                                             group_decode_queries)
from repro_torch.kernels.paged_attn import (paged_attention_state,
                                            paged_attention_state_plain)

DEFAULT_KV_BLOCK = 1024

# --- initializers -----------------------------------------------------------
# Same shapes, distributions and scales as the JAX initializers; the numbers
# come from the caller's torch.Generator (drawn on its device), so they are
# not the JAX ones — the tests carry JAX params across instead.


def dense_init(gen: torch.Generator, k: int, n: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    scale = (2.0 / (k + n)) ** 0.5
    w = torch.randn((k, n), generator=gen, device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, v: int, d: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    w = torch.randn((v, d), generator=gen, device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


# --- norms ------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm with the population variance (``jnp.var``), f32 inside,
    rounded back to the input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


# --- rotary -----------------------------------------------------------------

def rope_freqs(head_dim: int, base: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (base ** exps)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, base, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- chunked attention (online softmax over KV blocks) -----------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, Dh) -> (B, S, KV*n_rep, Dh) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


def chunked_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                      window: int | None = None,
                      kv_block: int = DEFAULT_KV_BLOCK):
    """Online-softmax attention over KV blocks of ``kv_block`` rows (the
    reference's scan, as a loop): q (B, Sq, H, Dh), k/v (B, Skv, KV, Dh)
    -> (B, Sq, H, Dh) in q's dtype.

    ``q_offset``: absolute position of q[0] (prefill: 0). ``window``: local
    attention window (keys at positions > q_pos - window); None = global.
    Scores are f32 sums of products of q (scaled in f32, rounded to the K/V
    dtype) and K; p stays f32 against an f32 V block. A fully masked row
    carries m = 0, as the reference's scan does.
    """
    b, sq, h, dh = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    n_rep = h // n_kv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    cdt = k.dtype
    qf = (q.float() * dh ** -0.5).to(cdt).float().transpose(1, 2)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, dh), device=q.device)
    for lo in range(0, skv, kv_block):
        hi = min(lo + kv_block, skv)
        kv_pos = torch.arange(lo, hi, device=q.device)
        s = qf @ k[:, lo:hi].float().permute(0, 2, 3, 1)   # (B, H, Sq, kb)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, hi - lo), dtype=torch.bool,
                              device=q.device)
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, lo:hi].float().transpose(1, 2)
        m = m_safe
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    return out.transpose(1, 2).to(q.dtype)                # (B, Sq, H, Dh)


# --- attention ---------------------------------------------------------------

def merge_attn_states(acc1, m1, l1, acc2, m2, l2):
    """Merge two unnormalized online-softmax states over disjoint key sets
    and normalize: acc (..., Dh) f32, m/l (...) f32 (m may be -inf where a
    state saw only masked keys)."""
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    a1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m_safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), 0.0)
    acc = acc1 * a1[..., None] + acc2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return acc / torch.clamp_min(l[..., None], 1e-20)


def _merge_self_term(acc, m, l, s_self, v_self):
    """Merge the current token's self-term into unnormalized online-softmax
    state and normalize: acc (B, KV, R, Dh) f32, m/l (B, KV, R) (m may be
    -inf for empty caches), s_self (B, KV, R) scores, v_self (B, KV, Dh)
    f32. The self token is a one-key state (m2 = s_self, l2 = 1,
    acc2 = v_self)."""
    acc_self = v_self[:, :, None, :].expand(acc.shape)
    return merge_attn_states(acc, m, l, acc_self, s_self,
                             torch.ones_like(s_self))


def _lengths(kv_len, b: int, device) -> torch.Tensor:
    """kv_len (a host int, or a tensor: scalar or (B,)) -> (B,) int32 on
    ``device``; a host int is filled in on the device (no host sync)."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len.to(device=device, dtype=torch.int32).reshape(-1) \
            .expand(b).contiguous()
    return torch.full((b,), int(kv_len), dtype=torch.int32, device=device)


def decode_attention_incremental(q, k_cache, v_cache, kv_len, k_new, v_new,
                                 window: int | None = None):
    """Decode attention over cache[0:kv_len] + the new token, WITHOUT
    reading the new token from the cache: the self-token term is merged
    analytically into the cache half's online-softmax state.

    q (B, 1, H, Dh); caches (B, S, KV, Dh) (row kv_len and later are not
    read); kv_len a host int or a tensor (scalar or (B,)); k_new/v_new
    (B, 1, KV, Dh) this token's K/V. Global attention goes through
    ``kernels.decode_attn.decode_attn`` on the queries grouped once for
    both halves (the kernel on CUDA tensors, its plain version, the
    reference's XLA branch, on the CPU);
    windowed attention (keys at positions >= kv_len - window + 1) takes
    the plain path on any device, as in the reference.
    """
    b, s, n_kv, dh = k_cache.shape
    h = q.shape[2]
    cdt = k_cache.dtype
    qf = group_decode_queries(q[:, 0], n_kv, cdt)
    s_self = torch.einsum("bkrd,bkd->bkr", qf.float(),
                          k_new[:, 0].to(cdt).float())      # (B,KV,R)
    lens = _lengths(kv_len, b, q.device)
    if window is None:
        acc, m, l = decode_attn(qf, k_cache, v_cache, lens)
    else:
        acc, m, l = decode_attention_state_plain(q[:, 0], k_cache, v_cache,
                                                 lens, window=window)
    out = _merge_self_term(acc, m, l, s_self, v_new.float()[:, 0])
    return out.reshape(b, 1, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, window: int | None = None):
    """Single-token decode attention over a (padded) KV cache: q
    (B, 1, H, Dh), caches (B, S, KV, Dh), kv_len (B,) or scalar.

    On CUDA tensors global attention runs the decode kernel and normalizes
    its state (``acc / l``, the reference's PALLAS branch). CPU tensors and
    windowed attention (keys at positions >= kv_len - window) take the
    reference's XLA branch: a masked softmax, p rounded to the cache dtype
    before the PV product.
    """
    b, s, n_kv, dh = k_cache.shape
    h = q.shape[2]
    cdt = k_cache.dtype
    lens = _lengths(kv_len, b, q.device)
    if window is None and q.is_cuda:
        acc, _, l = decode_attention_state(q[:, 0], k_cache, v_cache, lens)
        out = acc / torch.clamp_min(l[..., None], 1e-20)
        return out.reshape(b, 1, h, dh).to(q.dtype)
    qf = group_decode_queries(q[:, 0], n_kv, cdt)
    scores = torch.einsum("bkrd,bskd->bkrs", qf.float(), k_cache.float())
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lens.long()[:, None]
    if window is not None:
        valid = valid & (pos[None, :] >= lens.long()[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p.to(cdt).float(), v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def chunk_attention_paged(q, k_pool, v_pool, block_tables, ctx_lens, k_new,
                          v_new, window: int | None = None):
    """Mixed-batch attention over a block-paged KV pool, WITHOUT writing it.

    q (B, T, H, Dh) chunk queries at absolute positions ctx_lens[b] + t;
    pools (n_blocks, block_size, KV, Dh) read-only; block_tables
    (B, max_blocks) int32; ctx_lens (B,) tokens already in the pool;
    k_new/v_new (B, T, KV, Dh) this chunk's K/V. The context half (all of
    it precedes the chunk) is the paged kernel's state — its plain version
    on the CPU, and the plain windowed path for windowed attention; the
    intra-chunk causal half is a small (T, T) masked softmax computed here.
    The two states merge through ``merge_attn_states``; decode is T=1.
    """
    b, t, h, dh = q.shape
    n_kv = k_new.shape[2]
    n_rep = h // n_kv
    ctx = torch.as_tensor(ctx_lens, dtype=torch.int32,
                          device=q.device).expand(b)
    # --- context half: paged pool, uniform mask ------------------------------
    if window is None:
        acc1, m1, l1 = paged_attention_state(q, k_pool, v_pool, block_tables,
                                             ctx)
    else:
        q_pos = ctx[:, None] + torch.arange(t, device=q.device)
        acc1, m1, l1 = paged_attention_state_plain(
            q, k_pool, v_pool, block_tables, ctx, window=window,
            q_positions=q_pos)
    acc1 = acc1.reshape(b, n_kv, t, n_rep, dh)
    m1 = m1.reshape(b, n_kv, t, n_rep)
    l1 = l1.reshape(b, n_kv, t, n_rep)
    # --- intra-chunk causal half (T is small; plain masked softmax) ----------
    cdt = k_pool.dtype
    qf = (q.float() * dh ** -0.5).reshape(b, t, n_kv, n_rep, dh).to(cdt)
    s2 = torch.einsum("btkrd,bukd->bktru", qf.float(),
                      k_new.to(cdt).float())              # (B, KV, T, rep, U)
    tt = torch.arange(t, device=q.device)
    mask = tt[None, :] <= tt[:, None]                     # key u <= query t
    if window is not None:
        mask = mask & (tt[None, :] > tt[:, None] - window)
    mask = mask[None, None, :, None, :]
    s2 = torch.where(mask, s2, float("-inf"))
    m2 = s2.amax(dim=-1)                      # finite: the self key survives
    p2 = torch.exp(s2 - m2[..., None])
    p2 = torch.where(mask, p2, 0.0)
    acc2 = torch.einsum("bktru,bukd->bktrd", p2.to(cdt).float(),
                        v_new.to(cdt).float())
    l2 = p2.sum(dim=-1)
    out = merge_attn_states(acc1, m1, l1, acc2, m2, l2)   # (B, KV, T, rep, Dh)
    return out.permute(0, 2, 1, 3, 4).reshape(b, t, h, dh).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_base: float = 10000.0
    use_rope: bool = True
    window: int | None = None


def qkv_project(p, x, cfg: AttnConfig, positions):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh) with rope + qk-norm;
    the projections through ``maybe_flash_matmul`` (DRAM or flash tier)."""
    b, s, _ = x.shape
    q = maybe_flash_matmul(x, p["wq"]).reshape(b, s, cfg.n_heads,
                                               cfg.head_dim)
    k = maybe_flash_matmul(x, p["wk"]).reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = maybe_flash_matmul(x, p["wv"]).reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v


# --- FFN variants ------------------------------------------------------------

def swiglu_apply(p, x):
    g = maybe_flash_matmul(x, p["w_gate"])
    u = maybe_flash_matmul(x, p["w_up"])
    h = F.silu(g.float()) * u.float()
    return maybe_flash_matmul(h.to(x.dtype), p["w_down"])


def gelu_ffn_apply(p, x):
    """GELU FFN; ``jax.nn.gelu`` is the tanh approximation by default."""
    h = F.gelu(maybe_flash_matmul(x, p["w_up"]).float(), approximate="tanh")
    return maybe_flash_matmul(h.to(x.dtype), p["w_down"])
