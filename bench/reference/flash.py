"""The flash tier as the configuration states it, worked out again from the
seed: symmetric per-output-channel INT8, Hamming(72,64) SEC-DED over each
8 consecutive INT8 weights of a column, and raw NAND bit errors at the
configuration's RBER. Frozen copies of the arithmetic the deployment
follows, so the reference never reads a byte the program made.

* ``quantize_int8`` -- amax over K, ``scale = amax / 127``, round half to
  even, clamp to [-127, 127].
* ``flip_sites`` -- each bit of a leaf's INT8 bytes flips with probability
  ``rber``: a binomial count, then that many distinct bit positions, from
  ``numpy.random.default_rng(seed)``; the leaf's seed is ``seed +
  crc32(path) % 2**31`` (``leaf_seed``), an Algorithm 2 Q/O flash copy's
  ``seed + layer``.
* ``correct`` -- SEC-DED: the parity byte is computed from the clean
  codeword, the received codeword is checked against it, and a single
  flipped data bit is repaired; two or more are left as they are (or, at
  three, repaired wrongly, as a Hamming code does).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

# --- quantization -------------------------------------------------------------


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> (q int8, scale (..., 1, N) f32), per column."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(w32 / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


# --- bit errors ---------------------------------------------------------------


def leaf_seed(seed: int, path: str) -> int:
    return seed + zlib.crc32(path.encode()) % (2**31)


def flip_sites(nbytes: int, rber: float, seed: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(sorted byte indices int64, XOR masks uint8) of the bit errors over
    ``nbytes`` bytes."""
    rng = np.random.default_rng(seed)
    nbits = nbytes * 8
    nflip = int(rng.binomial(nbits, rber)) if rber > 0 else 0
    if not nflip:
        return np.zeros((0,), np.int64), np.zeros((0,), np.uint8)
    pos = rng.choice(nbits, size=nflip, replace=False)
    idx, inv = np.unique(pos // 8, return_inverse=True)
    masks = np.zeros(idx.shape, np.uint8)
    np.bitwise_xor.at(masks, inv, (1 << (pos % 8)).astype(np.uint8))
    return idx.astype(np.int64), masks


# --- Hamming(72,64) SEC-DED ---------------------------------------------------
# Logical positions 1..71; powers of two carry the Hamming parity bits and
# the 64 others the data bits, data bit i being bit i % 8 of byte i // 8.

_DATA_POS = np.array([p for p in range(1, 72) if p & (p - 1)], np.int64)
_SYN_BIT = np.full((128,), -1, np.int64)          # syndrome -> data bit
_SYN_BIT[_DATA_POS] = np.arange(64)


def _bits(cw: torch.Tensor) -> torch.Tensor:
    """(G, 8) uint8 codewords -> (G, 64) int64 data bits."""
    shifts = torch.arange(8, device=cw.device)
    return ((cw.long()[:, :, None] >> shifts) & 1).reshape(-1, 64)


def _syndrome(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, 64) data bits -> (Hamming syndrome bits (G,) 0..127, parity of
    the data bits (G,))."""
    pos = torch.as_tensor(_DATA_POS, device=bits.device)
    syn = torch.zeros(bits.shape[0], dtype=torch.long, device=bits.device)
    for k in range(7):
        mask = ((pos >> k) & 1).bool()
        syn |= (bits[:, mask].sum(dim=1) & 1) << k
    return syn, bits.sum(dim=1) & 1


def correct(clean: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    """SEC-DED over (G, 8) uint8 codewords: the parity is the clean
    codeword's (the flips hit data bytes only), the result what the decoder
    makes of the received bytes."""
    if clean.numel() == 0:
        return received
    syn_c, par_c = _syndrome(_bits(clean))
    overall_c = par_c ^ _popcount7(syn_c)          # stored overall bit
    bits_r = _bits(received)
    syn_r, par_r = _syndrome(bits_r)
    syndrome = syn_r ^ syn_c
    odd = (par_r ^ _popcount7(syn_c) ^ overall_c).bool()
    fix = torch.as_tensor(_SYN_BIT, device=clean.device)[syndrome]
    repair = odd & (fix >= 0)
    rows = torch.nonzero(repair)[:, 0]
    bits_r[rows, fix[rows]] ^= 1
    shifts = torch.arange(8, device=clean.device)
    return (bits_r.reshape(-1, 8, 8) << shifts).sum(-1).to(torch.uint8)


def _popcount7(s: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(s)
    for k in range(7):
        out ^= (s >> k) & 1
    return out


# --- the weight as the ECDP reads it ------------------------------------------


def flash_weight(w: torch.Tensor, sites: tuple[np.ndarray, np.ndarray],
                 first_byte: int, ecc: bool) -> torch.Tensor:
    """The f32 weight that ``w``'s (..., K, N) flash copy stands for after
    its bit errors: ``sites`` are the leaf's, ``first_byte`` the offset of
    ``w``'s first INT8 byte in the leaf (matrices row-major over the lead
    dims, each K x N row-major), ``ecc`` whether SEC-DED corrects it."""
    q, scale = quantize_int8(w)
    flat = q.view(torch.uint8).reshape(-1)
    idx, masks = sites
    lo, hi = np.searchsorted(idx, [first_byte, first_byte + flat.numel()])
    if hi > lo:
        i = torch.as_tensor(idx[lo:hi] - first_byte, device=w.device)
        m = torch.as_tensor(masks[lo:hi], device=w.device)
        if not ecc:
            flat[i] ^= m
        else:
            k, n = q.shape[-2:]
            mat, rem = i // (k * n), i % (k * n)
            # the codewords hit: (matrix, row group of 8, column)
            cw = torch.unique(mat * (k * n) + (rem // n // 8) * 8 * n
                              + rem % n)
            rows = cw[:, None] + torch.arange(8, device=w.device)[None] * n
            clean = flat[rows].clone()
            flat[i] ^= m
            flat[rows] = correct(clean, flat[rows])
    return q.float() * scale
