"""Paged ECDP — the error-corrected INT8 matmul over the weight page pool:
the wrapper of the Hopper kernel (``csrc/paged_ecdp.cu``) and its plain
PyTorch version.

Port of ``repro/kernels/paged_ffn.py`` (``gather_q``, ``gather_parity``,
``gather_scale``, ``paged_ecdp_matmul_xla``) and ``ops.paged_ecdp_matmul``
(the Pallas path): ``(M,K) float x pool-paged (K,N) int8 -> (M,N) f32``.
The weight is raw 16 KiB store pages in a ``(n_pages, 16384)`` int8 pool:
q as 128x128 tiles named by ``q_tbl (kt, nt)``, parity and scales as flat
byte runs over the pages ``p_slots`` and ``s_slots``.

``paged_ecdp_matmul`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version only for CPU
tensors. ``paged_ecdp_matmul.launches`` counts kernel launches. The kernel
uses ECDP's K split (``ecdp._splits``), so its output is bit-identical to
``ecdp_matmul`` on the dense weight with the same bytes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ecdp import _splits, ecdp_matmul_plain

TILE = 128
PAGE_BYTES = TILE * TILE          # one 128x128 int8 tile == one 16 KiB page


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gather_q(pool: torch.Tensor, q_tbl: torch.Tensor, k: int, n: int
             ) -> torch.Tensor:
    """Dense (K, N) int8 weight from the pool pages named by ``q_tbl`` —
    the inverse of ``PageStore._put_tiled``."""
    kt, nt = q_tbl.shape
    tiles = pool.view(-1, TILE, TILE)[q_tbl.long()]      # (kt, nt, T, T)
    full = tiles.permute(0, 2, 1, 3).reshape(kt * TILE, nt * TILE)
    return full[:k, :n]


def gather_parity(pool: torch.Tensor, p_slots: torch.Tensor, k: int, n: int
                  ) -> torch.Tensor:
    """Dense (K//8, N) uint8 parity plane from its flat page run (the run
    is sliced before the dtype view, so the view is of a contiguous,
    aligned tensor)."""
    raw = pool[p_slots.long()].reshape(-1)[:(k // 8) * n]
    return raw.view(torch.uint8).reshape(k // 8, n)


def gather_scale(pool: torch.Tensor, s_slots: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """(1, N) f32 dequant scales from their flat page run (4-byte runs
    viewed as float32)."""
    raw = pool[s_slots.long()].reshape(-1)[:4 * n]
    return raw.view(torch.float32).reshape(1, n)


def paged_ecdp_matmul_plain(a: torch.Tensor, pool: torch.Tensor,
                            q_tbl: torch.Tensor, p_slots: torch.Tensor,
                            s_slots: torch.Tensor, kn: tuple,
                            ecc_enabled: bool = True) -> torch.Tensor:
    """The plain version: gather the dense weight from the pool, then the
    resident ECDP math (``ecdp_matmul_plain``)."""
    k, n = kn
    return ecdp_matmul_plain(a, gather_q(pool, q_tbl, k, n).contiguous(),
                             gather_parity(pool, p_slots, k, n),
                             gather_scale(pool, s_slots, n), ecc_enabled)


def _check(a, pool, q_tbl, p_slots, s_slots, kn):
    """What the kernel takes, checked on both devices (so the CPU tests
    catch a caller the card would refuse)."""
    dev = a.device
    for name, t in (("pool", pool), ("q_tbl", q_tbl), ("p_slots", p_slots),
                    ("s_slots", s_slots)):
        if t.device != dev:
            raise ValueError(f"paged_ecdp_matmul: {name} on {t.device}, a on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_ecdp_matmul: {name} must be contiguous")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_ecdp_matmul: a must be bf16 or f32, got "
                        f"{a.dtype}")
    if pool.dtype != torch.int8 or pool.ndim != 2 \
            or pool.shape[1] != PAGE_BYTES:
        raise TypeError(f"paged_ecdp_matmul: pool must be (n_pages, "
                        f"{PAGE_BYTES}) int8, got {tuple(pool.shape)} "
                        f"{pool.dtype}")
    for name, t in (("q_tbl", q_tbl), ("p_slots", p_slots),
                    ("s_slots", s_slots)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_ecdp_matmul: {name} must be int32, got "
                            f"{t.dtype}")
    if a.ndim != 2 or not a.is_contiguous():
        raise ValueError("paged_ecdp_matmul: a must be a contiguous (M, K)")
    k, n = (int(d) for d in kn)
    if a.shape[1] != k or k % 8:
        raise ValueError(f"paged_ecdp_matmul: a {tuple(a.shape)} against "
                         f"K={k} (K must be a multiple of 8)")
    if tuple(q_tbl.shape) != (_cdiv(k, TILE), _cdiv(n, TILE)):
        raise ValueError(f"paged_ecdp_matmul: q_tbl {tuple(q_tbl.shape)} "
                         f"is not the tile grid of ({k}, {n})")
    if p_slots.ndim != 1 or p_slots.numel() < _cdiv((k // 8) * n,
                                                    PAGE_BYTES):
        raise ValueError("paged_ecdp_matmul: p_slots too short for the "
                         f"({k // 8}, {n}) parity run")
    if s_slots.ndim != 1 or s_slots.numel() < _cdiv(4 * n, PAGE_BYTES):
        raise ValueError(f"paged_ecdp_matmul: s_slots too short for {n} "
                         "scales")
    if max(a.shape[0], k, n) >= 2**31:
        raise ValueError("paged_ecdp_matmul: dims must fit in int32")


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    lib = build.load("paged_ecdp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_ecdp_matmul.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i,
                                      i, p]
    lib.paged_ecdp_matmul.restype = ctypes.c_int
    return lib


def paged_ecdp_matmul(a: torch.Tensor, pool: torch.Tensor,
                      q_tbl: torch.Tensor, p_slots: torch.Tensor,
                      s_slots: torch.Tensor, kn: tuple,
                      ecc_enabled: bool = True) -> torch.Tensor:
    """Paged ECDP matmul: (M, K) x pool-paged (K, N) int8 -> (M, N) f32.
    CUDA tensors run the paged ECDP kernel; CPU tensors the plain
    version."""
    _check(a, pool, q_tbl, p_slots, s_slots, kn)
    if not a.is_cuda:
        return paged_ecdp_matmul_plain(a, pool, q_tbl, p_slots, s_slots, kn,
                                       ecc_enabled)
    m = a.shape[0]
    k, n = (int(d) for d in kn)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    splits = _splits(a.device, k, n)
    partial = (torch.empty((splits, min(m, 64), n), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.paged_ecdp_matmul(
            a.data_ptr(), int(a.dtype == torch.bfloat16), pool.data_ptr(),
            q_tbl.data_ptr(), p_slots.data_ptr(), s_slots.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            m, k, n, q_tbl.shape[1], splits, int(bool(ecc_enabled)), stream)
    if err:
        raise RuntimeError(f"paged_ecdp_matmul: CUDA error {err} at launch")
    paged_ecdp_matmul.launches += 1
    return out


paged_ecdp_matmul.launches = 0
