"""Decode attention over a contiguous KV cache: the wrapper of the Hopper
kernel (``csrc/decode_attn.cu``), its plain PyTorch version (the reference's
XLA branch, window mask included), and the plain version in the kernel's
own order with the checks a kernel's output is held to (``kernel_errors``).

Port of ``repro/kernels/decode_attn.py`` (``decode_attn_pallas``) and
``ops.decode_attention_state``. One query per slot attends the slot's
live prefix of the ``(B, S_max, KV, Dh)`` caches, ``kv_pos < length``; the
GQA query heads are grouped ``(B, KV, rep, Dh)``, pre-scaled by ``Dh^-0.5``
in f32 and cast to the cache dtype. Every function returns the
unnormalised online-softmax state ``acc (B,KV,rep,Dh), m, l (B,KV,rep)``,
f32; an empty slot gives m=-inf, l=0, acc=0.

``decode_attn`` (grouped queries, as ``decode_attn_pallas`` takes them) and
``decode_attention_state`` (unscaled queries, grouped first) launch the
kernel for CUDA tensors and raise on anything the kernel does not take;
they take the plain version only for CPU tensors.
``decode_attention_state.launches`` counts kernel launches through either.
On the card the kernel takes Dh a multiple of 16 up to 256
(``takes_head_dim``): a bf16 cache with Dh in 32, 64, 80, 128 (q and caches
on 16-byte boundaries) runs the tensor-core body; f32 caches, the other
head sizes and unaligned caches the CUDA-core body, over the same ranges
and chunks (``uses_mma``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

_MAX_SMEM = 227 * 1024      # dynamic shared memory one H100 block may use
# The kernel's walk: a slot's live prefix is cut into SPLIT_ROWS-row ranges,
# one warp (tensor-core body) or thread block (CUDA-core body) each, merged
# by a second kernel; each range updates its online softmax TILE_ROWS rows
# at a time (csrc/decode_attn.cu's CHUNK and TILE).
SPLIT_ROWS = 64
TILE_ROWS = 32
# the tensor-core body (csrc/decode_attn.cu): its head sizes, the units of
# a warp's K/V ring (STAGES) and the KV heads a thread block holds (MAX_HPB)
_MMA_HEAD_DIMS = (32, 64, 80, 128)
_STAGES = 2
_MAX_HEADS_PER_BLOCK = 4

# Unit roundoff of p's rounding to the cache dtype, for the acc bound of
# kernel_errors: bf16 keeps 8 significant bits; an f32 cache does not round
# p, and 2^-16 stands far above the f32 reorderings left.
_P_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -16}


def takes_head_dim(dh: int) -> bool:
    """Whether the card's kernel takes head size ``dh``: the CUDA-core body
    takes a multiple of 16 up to 256 (its lanes idle past Dh in a partial
    32-column step), the tensor-core body the bf16 caches at
    ``_MMA_HEAD_DIMS``."""
    return dh % 16 == 0 and 16 <= dh <= 256


def group_decode_queries(q: torch.Tensor, n_kv: int, cdt) -> torch.Tensor:
    """(B, H, Dh) unscaled -> (B, KV, rep, Dh) scaled, cache dtype."""
    b, h, dh = q.shape
    return ((q.float() * dh ** -0.5).reshape(b, n_kv, h // n_kv, dh)
            .to(cdt).contiguous())


def _masked_scores(q, k_cache, lengths, window=None):
    """f32 scores (B, KV, R, S) over the cache, -inf where masked, and the
    mask (B, 1, 1, S). ``window``: keys at positions >= length - window + 1
    only (the incremental decode's window, whose query sits at length)."""
    s = k_cache.shape[1]
    scores = torch.einsum("bkrd,bskd->bkrs", q.to(k_cache.dtype).float(),
                          k_cache.float())
    pos = torch.arange(s, device=q.device)
    lens = lengths.long()[:, None]
    valid = pos[None, :] < lens
    if window is not None:
        valid = valid & (pos[None, :] >= lens - window + 1)
    valid = valid[:, None, None, :]
    return torch.where(valid, scores, float("-inf")), valid


def decode_attn_plain(q, k_cache, v_cache, lengths, *,
                      window: int | None = None):
    """The plain version on grouped queries: masked softmax state in f32
    against the global max, p rounded to the cache dtype before the PV
    product (bf16 operands are exact in f32, so the products match the
    reference's bf16 contractions with f32 accumulation)."""
    scores, valid = _masked_scores(q, k_cache, lengths, window)
    m = scores.amax(dim=-1)                       # -inf for empty slots
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(valid, p, 0.0)
    acc = torch.einsum("bkrs,bskd->bkrd", p.to(k_cache.dtype).float(),
                       v_cache.float())
    return acc, m, p.sum(dim=-1)


def decode_attn_plain_ordered(q, k_cache, v_cache, lengths, *,
                              split: int = SPLIT_ROWS, tile: int = TILE_ROWS):
    """The plain version in the kernel's own order, to hold the kernel to
    f32 rounding: online softmax over ``tile``-row tiles, p rounded to the
    cache dtype against the running max, the rows cut into ``split``-row
    ranges whose states are merged at the end. ``split >= S_max`` with
    ``tile = block_s`` is the TPU kernel's single sequential walk. Masked
    keys never set the max."""
    if split % tile:
        raise ValueError("split must be a multiple of tile")
    b, n_kv, r, dh = q.shape
    s_max = k_cache.shape[1]
    split = min(split, -(-s_max // tile) * tile)
    n_split = -(-s_max // split)
    pad = n_split * split - s_max
    kp = torch.nn.functional.pad(k_cache, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v_cache, (0, 0, 0, 0, 0, pad))
    scores, valid = _masked_scores(q, kp, lengths.clamp(max=s_max))
    n_tile = split // tile
    s = scores.reshape(b, n_kv, r, n_split, n_tile, tile)
    valid = valid.reshape(b, 1, 1, n_split, n_tile, tile)
    m_run = s.amax(-1).cummax(-1).values          # (B,KV,R,S,T)
    p = torch.exp(s - torch.where(torch.isfinite(m_run), m_run, 0.0)[..., None])
    p = torch.where(valid, p, 0.0)
    # each tile's terms rescaled from its running max to the split's max
    m_split = m_run[..., -1]                      # (B,KV,R,S)
    fin = torch.isfinite(m_split)
    to_split = torch.where(torch.isfinite(m_run), torch.exp(
        m_run - torch.where(fin, m_split, 0.0)[..., None]), 0.0)
    l_split = (p.sum(-1) * to_split).sum(-1)
    vg = vp.float().reshape(b, n_split, n_tile, tile, n_kv, dh)
    pv = torch.einsum("bkrsjt,bsjtkd->bkrsjd", p.to(k_cache.dtype).float(),
                      vg)
    acc_split = (pv * to_split[..., None]).sum(-2)  # (B,KV,R,S,Dh)
    # merge the splits
    m = m_split.amax(-1)
    to_all = torch.where(fin, torch.exp(
        m_split - torch.where(torch.isfinite(m), m, 0.0)[..., None]), 0.0)
    return ((acc_split * to_all[..., None]).sum(-2), m,
            (l_split * to_all).sum(-1))


# What kernel_errors holds a kernel's state to:
#   m   f32 scores summed in another order: |dm| <= 1e-5 (1 + |m|);
#   l   sums of unrounded p, rescaled online: |dl| <= 1e-5 + 1e-4 l;
#   acc against the plain version: the kernel rounds p to the cache dtype
#       against the running max, the plain version against the global max.
#       Each rounding moves a p by at most u of itself (u = _P_ROUNDOFF),
#       independently, so an element's difference is a sum of independent
#       terms whose spread is below u * sqrt(sum p^2) * max|v|; the bound is
#       4 times that;
#   acc against the plain version in the kernel's order (same roundings):
#       ||d acc||_F <= 2e-4 ||acc||_F. Only a rounding of p that an f32
#       difference in a score tips the other way is left; leaving the bf16
#       rounding of p out moves acc by about 8e-4.
ORDERED_REL_TOL = 2e-4


def kernel_errors(q, k_cache, v_cache, lengths, acc, m, l, *,
                  split: int = SPLIT_ROWS, tile: int = TILE_ROWS) -> dict:
    """How far a kernel's state (acc, m, l) is from the plain versions on
    the same grouped inputs. Returns each check's error over its bound (at
    most 1 for a kernel that agrees; see above) and ``max_abs_err``, the
    largest difference from the plain version over acc, m and l."""
    acc_w, m_w, l_w = decode_attn_plain(q, k_cache, v_cache, lengths)
    acc_o, _, _ = decode_attn_plain_ordered(q, k_cache, v_cache, lengths,
                                            split=split, tile=tile)
    scores, _ = _masked_scores(q, k_cache, lengths)
    live = torch.isfinite(m_w)
    m_safe = torch.where(live, m_w, 0.0)
    p_norm = torch.exp(2 * (scores - m_safe[..., None])).sum(-1).sqrt()
    u = _P_ROUNDOFF[k_cache.dtype]
    acc_tol = 4 * u * p_norm * v_cache.float().abs().max() + 1e-5
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


def _check(q, k_cache, v_cache, lengths):
    """What the kernel takes, checked on both devices (so the CPU tests
    catch a caller the card would refuse); dtypes and Dh only on CUDA."""
    dev = q.device
    ts = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
          ("lengths", lengths))
    for name, t in ts:
        if t.device != dev:
            raise ValueError(f"decode_attn: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attn: {name} must be contiguous")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attn: lengths must be int32")
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError("decode_attn: q (B,KV,rep,Dh), caches (B,S,KV,Dh)")
    b, n_kv, _, dh = q.shape
    if k_cache.shape[0] != b or tuple(k_cache.shape[2:]) != (n_kv, dh) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attn: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError("decode_attn: lengths (B,)")
    if q.is_cuda:
        if k_cache.dtype not in _P_ROUNDOFF or q.dtype != k_cache.dtype \
                or v_cache.dtype != k_cache.dtype:
            raise TypeError("decode_attn: the kernel takes q and caches in "
                            f"one dtype, bf16 or f32 (got {q.dtype}, "
                            f"{k_cache.dtype}, {v_cache.dtype})")
        if not takes_head_dim(dh):
            raise ValueError(f"decode_attn: the kernel takes Dh a multiple "
                             f"of 16 up to 256: the tensor-core body Dh in "
                             f"{_MMA_HEAD_DIMS} (bf16), the CUDA-core body "
                             f"the rest (got {dh})")
        if b > 65535 or n_kv > 65535 \
                or -(-k_cache.shape[1] // SPLIT_ROWS) > 65535:
            raise ValueError("decode_attn: B, KV and the ranges of S_max "
                             "must fit a grid axis")
        if q.numel() >= 2 ** 31:
            raise ValueError("decode_attn: B*KV*rep*Dh must stay below 2^31")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attn.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.decode_attn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    return _bind(build.load("decode_attn"))


def uses_mma(q, k_cache, v_cache) -> bool:
    """Whether the card runs the tensor-core body on these (checked)
    inputs: a bf16 cache, Dh in _MMA_HEAD_DIMS, and q and both caches on
    16-byte boundaries (its 16-byte copies); else the CUDA-core body."""
    return (k_cache.dtype == torch.bfloat16 and q.shape[-1] in _MMA_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)))


def smem_bytes(rep: int, dh: int, *, n_kv: int = 1, mma: bool = False) -> int:
    """Dynamic shared memory one split block takes, in bytes (as the kernel
    sizes it). Tensor-core body: a ring of _STAGES units of TILE_ROWS
    cache rows padded by 8 elements, bf16, for each of min(KV, 4) warps.
    CUDA-core body: q and acc (rep x Dh), p (rep x TILE_ROWS), m, l and
    alpha, f32."""
    if mma:
        return (min(n_kv, _MAX_HEADS_PER_BLOCK) * _STAGES * TILE_ROWS
                * (dh + 8) * 2)
    return 4 * (2 * rep * dh + rep * TILE_ROWS + 3 * rep)


def _launch(lib, q, k_cache, v_cache, lengths):
    """Allocate the outputs and launch ``lib``'s kernel on the current
    stream (checked inputs on the card; no count)."""
    b, n_kv, rep, dh = q.shape
    s_max = k_cache.shape[1]
    acc = torch.empty((b, n_kv, rep, dh), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((b, n_kv, rep), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if acc.numel() == 0 or s_max == 0:
        return acc.zero_(), m.fill_(float("-inf")), l.zero_()
    mma = uses_mma(q, k_cache, v_cache)
    need = smem_bytes(rep, dh, n_kv=n_kv, mma=mma)
    if need > _MAX_SMEM:
        raise ValueError(f"decode_attn: rep={rep}, Dh={dh} need {need} B of "
                         "shared memory")
    n_split = -(-s_max // SPLIT_ROWS)
    acc_p = torch.empty((n_split,) + tuple(acc.shape), dtype=torch.float32,
                        device=q.device)
    m_p = torch.empty((n_split,) + tuple(m.shape), dtype=torch.float32,
                      device=q.device)
    l_p = torch.empty_like(m_p)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), b, s_max, n_kv,
            rep, dh, SPLIT_ROWS, int(k_cache.dtype == torch.bfloat16),
            int(mma), stream)
    if err:
        raise RuntimeError(f"decode_attn: CUDA error {err} at launch")
    return acc, m, l


def decode_attn(qg, k_cache, v_cache, lengths):
    """Decode attention state on grouped queries: qg (B, KV, rep, Dh)
    pre-scaled in the cache dtype (``group_decode_queries``); caches
    (B, S_max, KV, Dh), bf16 or f32; lengths (B,) int32 live prefix per
    slot. Returns (acc (B,KV,rep,Dh) unnormalised, m, l (B,KV,rep)), f32.
    CUDA tensors run the kernel (counted on
    ``decode_attention_state.launches``); CPU tensors the plain version."""
    _check(qg, k_cache, v_cache, lengths)
    if not qg.is_cuda:
        return decode_attn_plain(qg, k_cache, v_cache, lengths)
    out = _launch(_lib(), qg, k_cache, v_cache, lengths)
    decode_attention_state.launches += 1
    return out


def decode_attention_state(q, k_cache, v_cache, lengths):
    """Decode attention state. q (B, H, Dh) one UNscaled query per slot;
    caches (B, S_max, KV, Dh), bf16 or f32; lengths (B,) int32 live prefix
    per slot. Returns (acc (B,KV,rep,Dh) unnormalised, m, l (B,KV,rep)),
    f32. The queries are grouped, then ``decode_attn``."""
    return decode_attn(group_decode_queries(q, k_cache.shape[2],
                                            k_cache.dtype),
                       k_cache, v_cache, lengths)


decode_attention_state.launches = 0


def decode_attention_state_plain(q, k_cache, v_cache, lengths, *,
                                 window: int | None = None):
    """The plain version over unscaled (B, H, Dh) queries — the reference's
    XLA branch of ``decode_attention_incremental``, and its windowed path
    (keys at positions >= length - window + 1)."""
    qg = group_decode_queries(q, k_cache.shape[2], k_cache.dtype)
    return decode_attn_plain(qg, k_cache, v_cache, lengths, window=window)
