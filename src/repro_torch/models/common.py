"""Shared functional layers — the port of the slice's part of
``repro/models/common.py``.

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
from repro_torch.kernels.paged_attn import (paged_attention_state,
                                            paged_attention_state_plain)

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
