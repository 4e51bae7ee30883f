"""ECDP — error-corrected INT8 matmul: the wrapper of the Hopper kernel
(``csrc/ecdp.cu``) and its plain PyTorch version.

Port of ``repro/kernels/ecdp.py`` + ``ops.ecdp_matmul`` (the Pallas path),
``ops.ecdp_matmul_xla`` and ``ref.ecdp_reference`` (the same math in plain
ops): ``(M,K) float x (K,N) raw int8 [+ parity (K//8,N) u8] -> (M,N) f32``
with per-column scales applied.

``ecdp_matmul`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version only for
CPU tensors. ``ecdp_matmul.launches`` counts kernel launches (wrapper
calls; one call may be two CUDA launches, the product and its split-K
reduce). ``launch_plan`` cuts a product into blocks and K splits; the paged
ECDP takes the same plan, so the two agree bit for bit on the same bytes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import ecc

# Weight rows corrected and multiplied per chunk in the plain version (a
# multiple of 8): bounds its temporaries at any width.
_PLAIN_K_CHUNK = 1024


def ecdp_matmul_plain(a: torch.Tensor, wq: torch.Tensor, parity: torch.Tensor,
                      scale: torch.Tensor, ecc_enabled: bool = True
                      ) -> torch.Tensor:
    """The plain version: correct every codeword (``ecc.check_and_correct``),
    then an f32 matmul and the per-column scale. Works over K in chunks."""
    m, k = a.shape
    n = wq.shape[1]
    a32 = a.float()
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, _PLAIN_K_CHUNK):
        k1 = min(k0 + _PLAIN_K_CHUNK, k)
        w = wq[k0:k1]
        if ecc_enabled:
            fixed, _, _ = ecc.check_and_correct(
                ecc.weights_to_bytes(w), parity[k0 // 8:k1 // 8])
            w = ecc.bytes_to_weights(fixed)
        out.addmm_(a32[:, k0:k1], w.float())
    return out * scale.float().reshape(1, n)


def _check(a, wq, parity, scale):
    """What the kernel takes, checked on both devices (so the CPU tests
    catch a caller the card would refuse)."""
    dev = a.device
    for name, t in (("wq", wq), ("parity", parity), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"ecdp_matmul: {name} on {t.device}, a on {dev}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ecdp_matmul: a must be bf16 or f32, got {a.dtype}")
    if wq.dtype != torch.int8 or parity.dtype != torch.uint8 \
            or scale.dtype != torch.float32:
        raise TypeError("ecdp_matmul: wq int8, parity uint8, scale f32 "
                        f"(got {wq.dtype}, {parity.dtype}, {scale.dtype})")
    if a.ndim != 2 or wq.ndim != 2:
        raise ValueError("ecdp_matmul: a (M,K) and wq (K,N) must be 2-D")
    m, k = a.shape
    k2, n = wq.shape
    if k != k2 or k % 8:
        raise ValueError(f"ecdp_matmul: K mismatch or K % 8 ({a.shape}, "
                         f"{wq.shape})")
    if tuple(parity.shape) != (k // 8, n) or scale.numel() != n:
        raise ValueError(f"ecdp_matmul: parity {tuple(parity.shape)} / "
                         f"scale {tuple(scale.shape)} do not fit ({k}, {n})")
    if max(m, k, n) >= 2**31:
        raise ValueError("ecdp_matmul: dims must fit in int32")
    for name, t in (("a", a), ("wq", wq), ("parity", parity),
                    ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"ecdp_matmul: {name} must be contiguous")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ecdp_matmul.argtypes = [p, i, p, p, p, p, p] + [i] * 7 + [p]
    lib.ecdp_matmul.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    return _bind(build.load("ecdp"))


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


COLS = 128        # output columns per thread block
STEP_K = 64       # K rows per step of the tensor-core body
F32_ROWS = 64     # rows per launch of the f32 (CUDA-core) body


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """How one (M,K) x (K,N) product is launched: the tensor-core body's M
    tile (16, 64 or 128 rows; the f32 body runs M in launches of 64 rows), K
    split into ``splits`` runs of ``k_split`` rows (a multiple of 8, so of
    whole codewords; the last run may be shorter), and the shape of the f32
    partial sums the splits write (None for one split)."""
    m_tile: int
    k_split: int
    splits: int
    partial: tuple | None


@functools.lru_cache(maxsize=4096)
def launch_plan(m: int, k: int, n: int, n_sms: int, bf16: bool = True
                ) -> Plan:
    """The launch plan of a product on a card with ``n_sms`` SMs.

    bf16 (tensor cores): M tile 16 up to 16 rows, 64 up to 64, else 128
    (the correction of a weight step is shared by the tile's rows); about four
    blocks per SM, but no more splits than keep the partials' bytes
    (splits * M * N * 4) within half the weight's (K * N), and each split
    whole 64-row steps. f32 (CUDA cores, as first written): about two
    blocks of 128 columns per SM, splits of whole codewords, M in 64-row
    launches that share the partials."""
    col_blocks = _cdiv(n, COLS)
    if bf16:
        m_tile = 16 if m <= 16 else 64 if m <= 64 else 128
        want = _cdiv(4 * n_sms, col_blocks * _cdiv(m, m_tile))
        splits = max(1, min(want, k // (8 * max(m, 1)), k // STEP_K))
        k_split = _cdiv(_cdiv(k, splits), STEP_K) * STEP_K
        rows = m
    else:
        m_tile = F32_ROWS
        splits = max(1, min(_cdiv(2 * n_sms, col_blocks), k // 64))
        k_split = _cdiv(k // 8, splits) * 8
        rows = min(m, F32_ROWS)
    splits = _cdiv(k, k_split)
    return Plan(m_tile, k_split, splits,
                (splits, rows, n) if splits > 1 else None)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def alloc(a: torch.Tensor, k: int, n: int, n_sms: int):
    """The launch plan of ``a`` (M,K) x (K,N) and the buffers it writes:
    (plan, out (M,N) f32, partial f32 or None), on ``a``'s device. Shared
    by the ECDP and the paged ECDP."""
    m = a.shape[0]
    plan = launch_plan(m, k, n, n_sms, a.dtype == torch.bfloat16)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    partial = (None if plan.partial is None or out.numel() == 0 else
               torch.empty(plan.partial, dtype=torch.float32,
                           device=a.device))
    return plan, out, partial


def _launch(lib, a, wq, parity, scale, ecc_enabled):
    """Allocate the output and the partials and launch ``lib``'s kernel on
    the current stream (checked inputs on the card; no count)."""
    m, k = a.shape
    n = wq.shape[1]
    plan, out, partial = alloc(a, k, n, _n_sms(a.device.index))
    if out.numel() == 0:
        return out
    bf16 = a.dtype == torch.bfloat16
    wide = n % 16 == 0 and _aligned(a, wq, parity)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ecdp_matmul(
            a.data_ptr(), int(bf16), wq.data_ptr(), parity.data_ptr(),
            scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            m, k, n, plan.k_split, plan.m_tile, int(wide),
            int(bool(ecc_enabled)), stream)
    if err:
        raise RuntimeError(f"ecdp_matmul: CUDA error {err} at launch")
    return out


def ecdp_matmul(a: torch.Tensor, wq: torch.Tensor, parity: torch.Tensor,
                scale: torch.Tensor, ecc_enabled: bool = True) -> torch.Tensor:
    """Error-corrected quantized matmul: (M,K) x (K,N) int8 -> (M,N) f32.

    a: activations (bf16 or f32); wq raw int8 weights; parity (K//8, N)
    uint8; scale (1, N) f32. CUDA tensors run the ECDP kernel; CPU tensors
    the plain version.
    """
    _check(a, wq, parity, scale)
    if not a.is_cuda:
        return ecdp_matmul_plain(a, wq, parity, scale, ecc_enabled)
    out = _launch(_lib(), a, wq, parity, scale, ecc_enabled)
    ecdp_matmul.launches += 1
    return out


ecdp_matmul.launches = 0
