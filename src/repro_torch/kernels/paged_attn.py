"""Block-paged attention over the serving KV pool: the wrapper of the Hopper
kernel (``csrc/paged_attn.cu``), its plain PyTorch version, the
window-masked plain path, and the plain version in the kernel's own order
with the checks a kernel's output is held to (``kernel_errors``).

Port of ``repro/kernels/paged_attn.py`` (``paged_attn_pallas``,
``paged_attn_xla``) and ``ops._group_chunk_queries`` /
``ops.paged_attention_state[_xla]``. The pool is ``(n_blocks, block_size,
KV, Dh)`` and a slot's logical KV sequence is scattered across the blocks
its block table names. Each slot's CHUNK of queries attends its cached
CONTEXT only (``kv_pos < ctx_len``), so the mask is uniform across the
chunk and the (T, rep) query axes fold into one ``TR = T*rep`` axis;
causality within the chunk is the caller's intra-chunk term
(models/common.chunk_attention_paged). All functions return the
unnormalised online-softmax state ``acc (B,KV,TR,Dh), m, l (B,KV,TR)``,
f32; an empty context gives m=-inf, l=0, acc=0.

``paged_attn`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take (on the card: a bf16 pool, Dh in 16, 32, 64, 80,
128, 16-byte-aligned q and pools); it takes the plain version only for CPU
tensors. ``paged_attn.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# pool blocks one warp walks: a context of n blocks spreads over
# ceil(n / 8) warps per (slot, head, m tile), merged by a second kernel
# (at most 32: the kernel holds a range's table entries one a lane)
_BLOCKS_PER_SPLIT = 8
# head sizes the kernel is instantiated for
_HEAD_DIMS = (16, 32, 64, 80, 128)


def takes_head_dim(dh: int) -> bool:
    """Whether the card's kernel takes head size ``dh``."""
    return dh in _HEAD_DIMS


def group_chunk_queries(q: torch.Tensor, n_kv: int, cdt) -> torch.Tensor:
    """(B, T, H, Dh) unscaled -> (B, KV, T*rep, Dh) scaled, pool dtype.
    TR index = t*rep + r."""
    b, t, h, dh = q.shape
    n_rep = h // n_kv
    qg = (q.float() * dh ** -0.5).reshape(b, t, n_kv, n_rep, dh)
    return (qg.permute(0, 2, 1, 3, 4).reshape(b, n_kv, t * n_rep, dh)
            .to(cdt).contiguous())


def _masked_scores(q, k_pool, block_tables, ctx_lens, window=None,
                   q_positions=None):
    """f32 scores (B, KV, TR, S_pad) over the blocks the table names, -inf
    where masked, and the mask (B, 1, 1|TR, S_pad)."""
    b, n_kv, tr, dh = q.shape
    block_size = k_pool.shape[1]
    s_pad = block_tables.shape[1] * block_size
    kg = k_pool[block_tables.long()].reshape(b, s_pad, n_kv, dh).float()
    scores = torch.einsum("bktd,bskd->bkts", q.to(k_pool.dtype).float(), kg)
    pos = torch.arange(s_pad, device=q.device)
    valid = (pos[None, :] < ctx_lens.long()[:, None])[:, None, :]  # (B,1,S)
    if window is not None:
        if q_positions is None:
            raise ValueError("windowed context needs q_positions")
        valid = valid & (pos[None, None, :]
                         > q_positions.long()[:, :, None] - window)
    valid = valid[:, None]                                     # (B,1,1|TR,S)
    return torch.where(valid, scores, float("-inf")), valid


def paged_attn_plain(q, k_pool, v_pool, block_tables, ctx_lens, *,
                     window: int | None = None,
                     q_positions: torch.Tensor | None = None):
    """The plain version: gather the blocks through the table, then masked
    softmax state in f32 (bf16 operands are exact in f32, so the products
    match the reference's bf16 contractions with f32 accumulation). Also
    the windowed path, which needs a per-query mask (``q_positions`` (B,
    TR) absolute positions)."""
    b, n_kv, tr, dh = q.shape
    s_pad = block_tables.shape[1] * k_pool.shape[1]
    scores, valid = _masked_scores(q, k_pool, block_tables, ctx_lens, window,
                                   q_positions)
    vg = v_pool[block_tables.long()].reshape(b, s_pad, n_kv, dh).float()
    m = scores.amax(dim=-1)                       # -inf for empty contexts
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(valid, p, 0.0)
    acc = torch.einsum("bkts,bskd->bktd", p.to(k_pool.dtype).float(), vg)
    return acc, m, p.sum(dim=-1)


def paged_attn_plain_ordered(q, k_pool, v_pool, block_tables, ctx_lens, *,
                             blocks_per_split: int = _BLOCKS_PER_SPLIT):
    """The plain version in the kernel's own order, to hold the kernel to
    f32 rounding: online softmax over pool blocks in table order, p rounded
    to the pool dtype against the running max, the table cut
    into ranges of ``blocks_per_split`` blocks whose states are merged at
    the end. ``blocks_per_split >= max_blocks`` is the TPU kernel's single
    sequential walk. Masked keys never set the max."""
    b, n_kv, tr, dh = q.shape
    block_size = k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    bps = min(blocks_per_split, max_blocks)
    n_split = -(-max_blocks // bps)
    tbl = torch.nn.functional.pad(block_tables, (0, n_split * bps - max_blocks))
    scores, valid = _masked_scores(q, k_pool, tbl, ctx_lens.clamp(
        max=max_blocks * block_size))
    shape = (b, n_kv, tr, n_split, bps, block_size)
    s = scores.reshape(shape)
    valid = valid.reshape(b, 1, 1, n_split, bps, block_size)
    m_run = s.amax(-1).cummax(-1).values          # (B,KV,TR,S,bps)
    p = torch.exp(s - torch.where(torch.isfinite(m_run), m_run, 0.0)[..., None])
    p = torch.where(valid, p, 0.0)
    # each block's terms rescaled from its running max to the split's max
    m_split = m_run[..., -1]                      # (B,KV,TR,S)
    fin = torch.isfinite(m_split)
    to_split = torch.where(torch.isfinite(m_run), torch.exp(
        m_run - torch.where(fin, m_split, 0.0)[..., None]), 0.0)
    l_split = (p.sum(-1) * to_split).sum(-1)
    vg = v_pool[tbl.long()].float().reshape(b, n_split, bps, block_size, n_kv,
                                            dh)
    pv = torch.einsum("bktsjr,bsjrkd->bktsjd", p.to(k_pool.dtype).float(),
                      vg)
    acc_split = (pv * to_split[..., None]).sum(-2)  # (B,KV,TR,S,Dh)
    # merge the splits
    m = m_split.amax(-1)
    to_all = torch.where(fin, torch.exp(
        m_split - torch.where(torch.isfinite(m), m, 0.0)[..., None]), 0.0)
    return ((acc_split * to_all[..., None]).sum(-2), m,
            (l_split * to_all).sum(-1))


# What kernel_errors holds a kernel's state to:
#   m   f32 scores summed in another order: |dm| <= 1e-5 (1 + |m|);
#   l   sums of unrounded p, rescaled online: |dl| <= 1e-5 + 1e-4 l;
#   acc against the plain version: the kernel rounds p to bf16 against the
#       running max, the plain version against the global max. Each rounding
#       moves a p by at most 2^-9 of itself, independently, so an element's
#       difference is a sum of independent terms whose spread is below
#       2^-8 * sqrt(sum p^2) * max|v|; the bound is 4 times that;
#   acc against the plain version in the kernel's order (same roundings):
#       ||d acc||_F <= 2e-4 ||acc||_F. Only a bf16 rounding that an f32
#       difference in a score tips the other way is left (about 2e-5);
#       leaving the bf16 rounding of p out moves acc by about 8e-4.
ORDERED_REL_TOL = 2e-4


def kernel_errors(q, k_pool, v_pool, block_tables, ctx_lens, acc, m, l, *,
                  blocks_per_split: int = _BLOCKS_PER_SPLIT) -> dict:
    """How far a kernel's state (acc, m, l) is from the plain versions on
    the same inputs. Returns each check's error over its bound (at most 1
    for a kernel that agrees; see above) and ``max_abs_err``, the largest
    difference from the plain version over acc, m and l."""
    acc_w, m_w, l_w = paged_attn_plain(q, k_pool, v_pool, block_tables,
                                       ctx_lens)
    acc_o, _, _ = paged_attn_plain_ordered(q, k_pool, v_pool, block_tables,
                                           ctx_lens,
                                           blocks_per_split=blocks_per_split)
    scores, _ = _masked_scores(q, k_pool, block_tables, ctx_lens)
    live = torch.isfinite(m_w)
    m_safe = torch.where(live, m_w, 0.0)
    p_norm = torch.exp(2 * (scores - m_safe[..., None])).sum(-1).sqrt()
    acc_tol = 2.0 ** -6 * p_norm * v_pool.float().abs().max() + 1e-5
    d_acc = (acc - acc_w).abs()
    d_m = torch.where(live, m - m_w, 0.0).abs()
    d_l = (l - l_w).abs()
    empty_ok = bool(torch.isneginf(m[~live]).all()) \
        and bool((l[~live] == 0).all()) and bool((acc[~live] == 0).all())
    ordered = torch.linalg.vector_norm(acc - acc_o) / (
        ORDERED_REL_TOL * torch.linalg.vector_norm(acc_o) + 1e-6)

    def worst(ratio):                   # a NaN anywhere fails the check
        return float(torch.nan_to_num(ratio, nan=float("inf")).max())
    return {
        "m": worst(d_m / (1e-5 * (1 + m_safe.abs()))),
        "l": worst(d_l / (1e-5 + 1e-4 * l_w)),
        "acc_vs_plain": worst(d_acc / acc_tol[..., None]),
        "acc_vs_ordered": worst(ordered),
        "empty_rows": 0.0 if empty_ok else float("inf"),
        "max_abs_err": max(float(d_acc.max()), float(d_m.max()),
                           float(d_l.max())),
    }


def _check(q, k_pool, v_pool, block_tables, ctx_lens):
    """What the kernel takes, checked on both devices (so the CPU tests
    catch a caller the card would refuse); the bf16 pool, the head size
    and the alignment only on CUDA."""
    dev = q.device
    ts = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
          ("block_tables", block_tables), ("ctx_lens", ctx_lens))
    for name, t in ts:
        if t.device != dev:
            raise ValueError(f"paged_attn: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attn: {name} must be contiguous")
    if q.is_cuda and (q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16
                      or v_pool.dtype != torch.bfloat16):
        raise TypeError("paged_attn: the kernel takes a bf16 pool and bf16 "
                        f"queries (got {q.dtype}, {k_pool.dtype})")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("paged_attn: block_tables and ctx_lens must be int32")
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError("paged_attn: q (B,KV,TR,Dh), pools (n,bs,KV,Dh)")
    b, n_kv, _, dh = q.shape
    n_blocks, block_size = k_pool.shape[:2]
    if tuple(k_pool.shape) != (n_blocks, block_size, n_kv, dh) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attn: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or tuple(ctx_lens.shape) != (b,):
        raise ValueError("paged_attn: block_tables (B, max_blocks), "
                         "ctx_lens (B,)")
    if q.is_cuda:
        if not takes_head_dim(dh) or q.shape[2] < 1 or block_size < 1:
            raise ValueError(f"paged_attn: the kernel takes Dh in {_HEAD_DIMS}"
                             ", TR >= 1 and block_size >= 1 (got Dh="
                             f"{dh}, TR={q.shape[2]}, block_size="
                             f"{block_size})")
        for name, t in ts[:3]:
            if t.data_ptr() % 16:
                raise ValueError(f"paged_attn: {name} must start on a 16-byte"
                                 " boundary (the kernel copies 16-byte runs)")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attn.argtypes = [p] * 11 + [i] * 8 + [p]
    lib.paged_attn.restype = ctypes.c_int
    lib.paged_attn_smem_bytes.argtypes = [i, i, i]
    lib.paged_attn_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    return _bind(build.load("paged_attn"))


def _launch(lib, q, k_pool, v_pool, block_tables, ctx_lens):
    """Allocate the outputs and launch ``lib``'s kernel on the current
    stream (checked inputs on the card; no count)."""
    b, n_kv, tr, dh = q.shape
    n_blocks, block_size = k_pool.shape[:2]
    acc = torch.empty((b, n_kv, tr, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((b, n_kv, tr), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if acc.numel() == 0:
        return acc, m.fill_(float("-inf")), l.zero_()
    max_blocks = block_tables.shape[1]
    n_split = -(-max_blocks // _BLOCKS_PER_SPLIT)
    acc_p = torch.empty((n_split,) + tuple(acc.shape), dtype=torch.float32,
                        device=q.device)
    m_p = torch.empty((n_split,) + tuple(m.shape), dtype=torch.float32,
                      device=q.device)
    l_p = torch.empty_like(m_p)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc_p.data_ptr(), m_p.data_ptr(),
            l_p.data_ptr(), b, n_kv, tr, dh, n_blocks, block_size,
            max_blocks, _BLOCKS_PER_SPLIT, stream)
    if err:
        raise RuntimeError(f"paged_attn: CUDA error {err} at launch")
    return acc, m, l


def paged_attn(q, k_pool, v_pool, block_tables, ctx_lens):
    """Paged context attention state. q (B, KV, TR, Dh) pre-scaled in the
    pool dtype; pools (n_blocks, block_size, KV, Dh); block_tables
    (B, max_blocks) int32 (0 = unmapped); ctx_lens (B,) int32. CUDA
    tensors run the kernel (bf16 pool); CPU tensors the plain version."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if not q.is_cuda:
        return paged_attn_plain(q, k_pool, v_pool, block_tables, ctx_lens)
    out = _launch(_lib(), q, k_pool, v_pool, block_tables, ctx_lens)
    paged_attn.launches += 1
    return out


paged_attn.launches = 0


def paged_attention_state(q, k_pool, v_pool, block_tables, ctx_lens):
    """(B, T, H, Dh) unscaled chunk queries -> the paged context state
    (acc (B,KV,T*rep,Dh), m, l) through ``paged_attn``."""
    qg = group_chunk_queries(q, k_pool.shape[2], k_pool.dtype)
    return paged_attn(qg, k_pool, v_pool, block_tables.int().contiguous(),
                      ctx_lens.int().contiguous())


def paged_attention_state_plain(q, k_pool, v_pool, block_tables, ctx_lens, *,
                                window: int | None = None,
                                q_positions: torch.Tensor | None = None):
    """The plain version over unscaled (B, T, H, Dh) queries — the windowed
    path (``q_positions`` (B, T) absolute positions)."""
    h = q.shape[2]
    n_kv = k_pool.shape[2]
    qg = group_chunk_queries(q, n_kv, k_pool.dtype)
    if q_positions is not None:
        q_positions = q_positions.repeat_interleave(h // n_kv, dim=1)
    return paged_attn_plain(qg, k_pool, v_pool, block_tables, ctx_lens,
                            window=window, q_positions=q_positions)
