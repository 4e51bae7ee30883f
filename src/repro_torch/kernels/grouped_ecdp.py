"""Expert-grouped ECDP — the wrapper of the Hopper kernel
(``csrc/grouped_ecdp.cu``) and its plain PyTorch version.

One launch multiplies every expert of an ``(E, K, N)`` flash-tier bank by
the rows routed to it: ``a`` (R, K) bf16 holds expert e's rows at
``row_start[e] .. row_start[e+1]-1``, and out (R, N) f32 holds
``(a @ correct(wq[e])) * scale[e]`` in the same rows (corrected only with
``ecc_enabled``). ``row_start`` (E+1,) int32 lives on the device, so the
launch reads no host value and a CUDA graph captures it. Rows outside
``row_start[0] .. row_start[E]-1`` are not written by the kernel (the plain
version leaves them zero). It stands where the reference maps
``ops.ecdp_matmul_xla`` over the bank (``models/moe.py::_expert_matmul``),
one product per expert over all columns of the dispatch buffer.

``grouped_ecdp_matmul`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take (f32 activations included: the
tensor-core body takes bf16); it takes the plain version only for CPU
tensors. ``grouped_ecdp_matmul.launches`` counts wrapper calls that
launch (one call may be two CUDA launches, the product and its per-expert
split-K reduce).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ecdp import (COLS, STEP_K, Plan, _aligned, _cdiv,
                                      _n_sms, ecdp_matmul_plain)


def grouped_ecdp_plain(a: torch.Tensor, row_start: torch.Tensor,
                       wq: torch.Tensor, parity: torch.Tensor,
                       scale: torch.Tensor, ecc_enabled: bool = True
                       ) -> torch.Tensor:
    """The plain version: ``ecdp_matmul_plain`` over each expert's rows
    (the row ranges read on the host)."""
    r, n = a.shape[0], wq.shape[2]
    out = torch.zeros((r, n), dtype=torch.float32, device=a.device)
    bounds = row_start.tolist()
    for e in range(wq.shape[0]):
        r0, r1 = bounds[e], bounds[e + 1]
        if r1 > r0:
            out[r0:r1] = ecdp_matmul_plain(a[r0:r1], wq[e], parity[e],
                                           scale[e], ecc_enabled)
    return out


def _check(a, row_start, wq, parity, scale):
    """What the kernel takes, checked on both devices (so the CPU tests
    catch a caller the card would refuse)."""
    dev = a.device
    for name, t in (("row_start", row_start), ("wq", wq),
                    ("parity", parity), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"grouped_ecdp: {name} on {t.device}, a on "
                             f"{dev}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"grouped_ecdp: a must be bf16, got {a.dtype}")
    if row_start.dtype != torch.int32 or wq.dtype != torch.int8 \
            or parity.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError("grouped_ecdp: row_start int32, wq int8, parity "
                        f"uint8, scale f32 (got {row_start.dtype}, "
                        f"{wq.dtype}, {parity.dtype}, {scale.dtype})")
    if a.ndim != 2 or wq.ndim != 3:
        raise ValueError("grouped_ecdp: a (R,K) and wq (E,K,N)")
    r, k = a.shape
    e, k2, n = wq.shape
    if k != k2 or k % 8:
        raise ValueError(f"grouped_ecdp: K mismatch or K % 8 ({a.shape}, "
                         f"{wq.shape})")
    if tuple(parity.shape) != (e, k // 8, n) \
            or tuple(scale.shape) != (e, 1, n) \
            or tuple(row_start.shape) != (e + 1,):
        raise ValueError(f"grouped_ecdp: parity {tuple(parity.shape)}, "
                         f"scale {tuple(scale.shape)}, row_start "
                         f"{tuple(row_start.shape)} do not fit ({e}, {k}, "
                         f"{n})")
    if max(r, k, n) >= 2**31 or not 1 <= e <= 65535:
        raise ValueError("grouped_ecdp: R, K, N must fit in int32 and E "
                         "in 1..65535 (the grid's expert axis)")
    for name, t in (("a", a), ("row_start", row_start), ("wq", wq),
                    ("parity", parity), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_ecdp: {name} must be contiguous")


@functools.lru_cache(maxsize=4096)
def grouped_plan(r: int, e: int, k: int, n: int, max_rows: int,
                 n_sms: int) -> Plan:
    """The launch plan of a grouped product on a card with ``n_sms`` SMs:
    M tile 16 where no expert gets more than 16 rows, else 64; K splits
    (whole 64-row steps) so that about four blocks per SM have rows, the
    experts with rows counted as at most min(E, R), and no more splits than
    keep the partials' bytes within half the busy experts' weight bytes."""
    m_tile = 16 if max_rows <= 16 else 64
    busy = min(e, r)
    want = _cdiv(4 * n_sms, _cdiv(n, COLS) * busy)
    splits = max(1, min(want, k // STEP_K, busy * k // (8 * max(r, 1))))
    k_split = _cdiv(_cdiv(k, splits), STEP_K) * STEP_K
    splits = _cdiv(k, k_split)
    return Plan(m_tile, k_split, splits,
                (splits, r, n) if splits > 1 else None)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_ecdp_matmul.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.grouped_ecdp_matmul.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    return _bind(build.load("grouped_ecdp"))


def grouped_ecdp_matmul(a: torch.Tensor, row_start: torch.Tensor,
                        wq: torch.Tensor, parity: torch.Tensor,
                        scale: torch.Tensor, ecc_enabled: bool = True,
                        max_rows: int | None = None,
                        plan_experts: int | None = None) -> torch.Tensor:
    """Expert-grouped error-corrected quantized matmul: (R,K) bf16 rows
    grouped by expert x (E,K,N) int8 -> (R,N) f32. ``max_rows`` is the
    most rows any expert can have (it picks the M tile; default R; more
    rows than it are still right, only slower). ``plan_experts`` (default
    E) is the expert count the launch plan is made for: a partial slab
    given the full bank's count gets the full bank's plan, and so its
    outputs bit for bit. CUDA tensors run the kernel; CPU tensors the
    plain version."""
    _check(a, row_start, wq, parity, scale)
    if not a.is_cuda:
        return grouped_ecdp_plain(a, row_start, wq, parity, scale,
                                  ecc_enabled)
    r, k = a.shape
    e, _, n = wq.shape
    out = torch.empty((r, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    plan = grouped_plan(r, e if plan_experts is None else int(plan_experts),
                        k, n, r if max_rows is None else max_rows,
                        _n_sms(a.device.index))
    partial = (None if plan.partial is None else
               torch.empty(plan.partial, dtype=torch.float32,
                           device=a.device))
    wide = n % 16 == 0 and _aligned(a, wq, parity)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().grouped_ecdp_matmul(
            a.data_ptr(), row_start.data_ptr(), wq.data_ptr(),
            parity.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            e, r, k, n, plan.k_split, plan.m_tile, int(wide),
            int(bool(ecc_enabled)), stream)
    if err:
        raise RuntimeError(f"grouped_ecdp_matmul: CUDA error {err} at launch")
    grouped_ecdp_matmul.launches += 1
    return out


grouped_ecdp_matmul.launches = 0
