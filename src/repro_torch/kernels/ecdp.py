"""ECDP — error-corrected INT8 matmul: the wrapper of the Hopper kernel
(``csrc/ecdp.cu``) and its plain PyTorch version.

Port of ``repro/kernels/ecdp.py`` + ``ops.ecdp_matmul`` (the Pallas path),
``ops.ecdp_matmul_xla`` and ``ref.ecdp_reference`` (the same math in plain
ops): ``(M,K) float x (K,N) raw int8 [+ parity (K//8,N) u8] -> (M,N) f32``
with per-column scales applied.

``ecdp_matmul`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version only for
CPU tensors. ``ecdp_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

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


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    lib = build.load("ecdp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ecdp_matmul.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.ecdp_matmul.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(dev: torch.device, k: int, n: int) -> int:
    """K splits so that about two blocks of 128 columns run per SM."""
    col_blocks = -(-n // 128)
    want = -(-2 * _n_sms(dev.index) // col_blocks)
    return max(1, min(want, k // 64))


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
    m, k = a.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    splits = _splits(a.device, k, n)
    partial = (torch.empty((splits, min(m, 64), n), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ecdp_matmul(
            a.data_ptr(), int(a.dtype == torch.bfloat16), wq.data_ptr(),
            parity.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            m, k, n, splits, int(bool(ecc_enabled)), stream)
    if err:
        raise RuntimeError(f"ecdp_matmul: CUDA error {err} at launch")
    ecdp_matmul.launches += 1
    return out


ecdp_matmul.launches = 0
