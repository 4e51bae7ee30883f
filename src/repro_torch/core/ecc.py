"""Hamming(72,64) SEC-DED codec over INT8 weight streams — the port of
``repro/core/ecc.py``.

A codeword protects 8 consecutive INT8 weights along the reduction (K)
axis: 64 data bits plus one parity byte (7 Hamming bits + 1 overall bit).
For a (K, N) weight matrix stored as raw uint8 bytes the parity plane is
(K//8, N). Semantics, held byte for byte against the JAX codec by the
tests:

  * any single flipped bit per codeword (data OR parity byte) -> corrected
  * any two flipped bits per codeword -> detected as uncorrectable
  * ``dirty`` flags every codeword whose received bits differ from encoded

The codec is linear over GF(2), so the plain PyTorch version looks up each
data byte's contribution in a per-byte-position table (7 Hamming bits and
the byte's parity in one uint8) and XORs the 8 lookups of a codeword. It
works over K in chunks of codeword rows, so no temporary grows with the
whole matrix (the JAX broadcast builds a (K/8, 7, 8, N) one). The ECDP
CUDA kernel computes the same bits with 64-bit masks and popcounts
(``kernels/csrc/ecdp.cu``).
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

# --- constant tables -------------------------------------------------------
# Logical Hamming positions 1..71; powers of two are parity positions.
_PARITY_POS = np.array([1, 2, 4, 8, 16, 32, 64], dtype=np.int32)
_DATA_POS = np.array(
    [p for p in range(1, 72) if p not in set(_PARITY_POS.tolist())], dtype=np.int32
)  # (64,) logical position of physical data bit i
assert _DATA_POS.shape == (64,)

# PHYS_MASK[k][b] : uint8 mask over data byte b selecting bits that feed
# Hamming parity k (bit i of byte b is data bit b*8+i).
_PHYS_MASK = np.zeros((7, 8), dtype=np.uint8)
for _k in range(7):
    for _i in range(64):
        if (_DATA_POS[_i] >> _k) & 1:
            _PHYS_MASK[_k, _i // 8] |= np.uint8(1 << (_i % 8))


def _parity8(v: np.ndarray) -> np.ndarray:
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


_VALUES = np.arange(256, dtype=np.uint8)
# _BYTE_SYN[b, v]: bits 0..6 = the Hamming bits byte value v contributes at
# byte position b of a codeword, bit 7 = the parity of v.
_BYTE_SYN = np.zeros((8, 256), dtype=np.uint8)
for _b in range(8):
    for _k in range(7):
        _BYTE_SYN[_b] |= (_parity8(_VALUES & _PHYS_MASK[_k, _b]) << _k).astype(np.uint8)
    _BYTE_SYN[_b] |= (_parity8(_VALUES) << 7).astype(np.uint8)
_PAR8 = _parity8(_VALUES).astype(np.uint8)                  # parity of a byte
# syndrome -> (data byte, bit mask) of the flipped data bit; byte 8 = none.
_SYN_BYTE = np.full((128,), 8, dtype=np.uint8)
_SYN_MASK = np.zeros((128,), dtype=np.uint8)
for _i, _p in enumerate(_DATA_POS):
    _SYN_BYTE[_p] = _i // 8
    _SYN_MASK[_p] = 1 << (_i % 8)

# codeword rows per chunk: bounds every temporary to ~4M elements
_CHUNK_ELEMS = 1 << 22


def tables() -> tuple[np.ndarray, np.ndarray]:
    """(phys_mask (7,8) u8, data_pos (64,) i32) as numpy — the codec's
    defining tables (the CUDA kernel's constants are checked against
    these)."""
    return _PHYS_MASK.copy(), _DATA_POS.copy()


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    as_t = functools.partial(torch.as_tensor, device=device)
    return (as_t(_BYTE_SYN), as_t(_PAR8), as_t(_SYN_BYTE), as_t(_SYN_MASK))


def _as_codewords(raw_bytes: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 -> (K//8, 8, N) codeword view."""
    k, n = raw_bytes.shape
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8 (codeword = 8 bytes)")
    if raw_bytes.dtype != torch.uint8:
        raise TypeError(f"raw bytes must be uint8, got {raw_bytes.dtype}")
    return raw_bytes.reshape(k // 8, 8, n)


def _chunks(g: int, n: int):
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    for g0 in range(0, g, rows):
        yield g0, min(g0 + rows, g)


def _syn_and_par(cw: torch.Tensor, byte_syn: torch.Tensor) -> torch.Tensor:
    """(G, 8, N) codewords -> (G, N) uint8: computed Hamming bits (0..6)
    and data parity (bit 7)."""
    h = byte_syn[0][cw[:, 0].long()]
    for b in range(1, 8):
        h ^= byte_syn[b][cw[:, b].long()]
    return h


def encode(raw_bytes: torch.Tensor) -> torch.Tensor:
    """Parity plane for (K, N) uint8 weight bytes -> (K//8, N) uint8."""
    cw = _as_codewords(raw_bytes)
    g, _, n = cw.shape
    byte_syn, par8, _, _ = _device_tables(raw_bytes.device)
    out = torch.empty((g, n), dtype=torch.uint8, device=raw_bytes.device)
    for g0, g1 in _chunks(g, n):
        h = _syn_and_par(cw[g0:g1], byte_syn)
        hamming = h & 0x7F
        overall = (h >> 7) ^ par8[hamming.long()]
        out[g0:g1] = hamming | (overall << 7)
    return out


def check_and_correct(raw_bytes: torch.Tensor, parity: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect + correct single-bit errors per codeword.

    raw_bytes (K, N) uint8 received weight bytes; parity (K//8, N) uint8
    received parity plane. Returns corrected (K, N) uint8 (single-bit data
    errors repaired), dirty (K//8, N) bool (a detected error, parity-only
    included) and uncorrectable (K//8, N) bool (double-bit or worse).
    """
    cw = _as_codewords(raw_bytes)
    g, _, n = cw.shape
    if parity.shape != (g, n):
        raise ValueError(f"parity {tuple(parity.shape)} != {(g, n)}")
    byte_syn, par8, syn_byte, syn_mask = _device_tables(raw_bytes.device)
    dev = raw_bytes.device
    corrected = torch.empty_like(cw)
    dirty = torch.empty((g, n), dtype=torch.bool, device=dev)
    uncorrectable = torch.empty((g, n), dtype=torch.bool, device=dev)
    for g0, g1 in _chunks(g, n):
        c = cw[g0:g1]
        p = parity[g0:g1]
        h = _syn_and_par(c, byte_syn)
        syndrome = (h ^ p) & 0x7F                                 # 0..127
        # data parity ^ stored Hamming parity ^ received overall bit
        is_err = ((h >> 7) ^ par8[p.long()]).bool()
        s = syndrome.long()
        flip_byte = torch.where(is_err, syn_byte[s], 8)
        flip_mask = syn_mask[s]
        for b in range(8):
            corrected[g0:g1, b] = c[:, b] ^ torch.where(flip_byte == b,
                                                        flip_mask, 0)
        s32 = syndrome.int()
        is_power = (s32 & (s32 - 1)) == 0                         # incl. 0
        data_hit = flip_byte < 8
        # dq==1: correctable iff the syndrome names a data position, a
        # parity position (power of two) or 0 (overall-bit flip).
        # dq==0 & syndrome!=0: double error.
        uncorrectable[g0:g1] = ((~is_err & (s32 != 0))
                                | (is_err & ~data_hit & ~is_power))
        dirty[g0:g1] = is_err | (s32 != 0)
    return corrected.reshape(raw_bytes.shape), dirty, uncorrectable


# --- host verify: the store's read-retry path -------------------------------
#
# The codec's parity bits are parities of masked bytes, and parity is
# linear: the parity of bit k over a codeword's 8 bytes is the parity of
# ONE byte, the XOR of the 8 masked bytes. A codeword's 8 bytes are 8
# consecutive rows of one column, so that XOR runs over whole rows, 8
# columns per uint64 word, and a byte's parity folds into its bit 0 with
# three shift-XORs. The encoded byte of the received data XOR the stored
# parity byte is the error byte ``e``: bits 0..6 the syndrome, and the
# parity of all of ``e`` the overall check (dq). ``e == 0`` is a clean
# codeword; only the few nonzero ones are classified and corrected, from
# the same syndrome tables as the plain version above. Chunks of pages
# run on a thread pool: numpy's loops release the GIL, and a dozen whole-
# array operations a chunk keep the threads off the interpreter. (PyTorch
# CPU ops over larger chunks ran at half the rate when called from the
# streamer's worker thread on the card machine's host.)

_LSB = {np.uint8: np.uint8(0x01), np.uint64: np.uint64(0x0101010101010101)}
# PHYS_MASK per (bit, byte) as (7, 8, 1) arrays, a byte (or a byte in each
# of a word's 8 lanes); and each bit's shift into the parity byte
_MASKS = {dt: (_PHYS_MASK.astype(dt) * dt(int(_LSB[dt])))[:, :, None]
          for dt in (np.uint8, np.uint64)}
_SHIFTS = {dt: np.arange(8, dtype=dt)[:, None] for dt in (np.uint8, np.uint64)}
_POW2_OR_0 = np.array([(s & (s - 1)) == 0 for s in range(128)], bool)
_CHUNK_BYTES = 2 << 20            # page bytes per thread task
_pool = None
_work = threading.local()


def _workspace(dt, n: int):
    """This thread's scratch arrays for ``_error_words`` over ``n`` words
    a row, reused across calls (fresh large arrays cost page faults)."""
    ws = getattr(_work, "ws", None)
    if ws is None or ws[0] != (dt, n):
        ws = ((dt, n), np.empty((8, n), dt), np.empty((7, 8, n), dt),
              np.empty((8, n), dt), np.empty((8, n), dt))
        _work.ws = ws
    return ws[1:]


def _error_words(cw: np.ndarray, parity: np.ndarray, out: np.ndarray):
    """(G, 8, W) codeword words (uint8 bytes or uint64 words of 8
    columns) and the (G, W) stored parity -> ``out`` (G, W): the encoded
    byte of the received data XOR the stored one."""
    dt = cw.dtype.type
    g, _, w = cw.shape
    rows, masked, bits, tmp = _workspace(dt, g * w)
    # byte position major: each of the 8 rows one contiguous run
    np.copyto(rows.reshape(8, g, w), cw.transpose(1, 0, 2))
    np.bitwise_and(rows[None], _MASKS[dt], out=masked)      # (7, 8, L)
    np.bitwise_xor.reduce(masked, axis=1, out=bits[:7])      # Hamming bits
    np.bitwise_xor.reduce(bits[:7], axis=0, out=tmp[0])
    np.bitwise_xor.reduce(rows, axis=0, out=bits[7])
    bits[7] ^= tmp[0]                 # overall: data and Hamming bits
    for sh in (4, 2, 1):              # each byte's parity -> its bit 0
        np.right_shift(bits, dt(sh), out=tmp)
        bits ^= tmp
    bits &= _LSB[dt]
    bits <<= _SHIFTS[dt]
    np.bitwise_or.reduce(bits, axis=0, out=out.reshape(-1))
    out ^= parity


def _errors(raw: np.ndarray, parity: np.ndarray, out: np.ndarray):
    """(G, 8, N) contiguous codeword bytes, (G, N) parity -> ``out``
    (G, N) uint8 error bytes, as uint64 words when N divides into them."""
    g, _, n = raw.shape
    if n % 8 == 0:
        raw, parity, out = (raw.view(np.uint64), parity.view(np.uint64),
                            out.view(np.uint64))
    _error_words(raw, parity, out)


def _thread_pool():
    global _pool
    if _pool is None:
        import concurrent.futures
        import os
        _pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="ecc-verify")
    return _pool


def page_errors(pages: np.ndarray, parity: np.ndarray) -> np.ndarray:
    """(n, K, N) uint8 pages, (n, K//8, N) parity -> (n, K//8, N) error
    bytes (0 = clean codeword)."""
    n, k, w = pages.shape
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8")
    if tuple(parity.shape) != (n, k // 8, w):
        raise ValueError(f"parity {tuple(parity.shape)} != "
                         f"{(n, k // 8, w)}")
    raw = np.ascontiguousarray(pages, np.uint8).reshape(n, k // 8, 8, w)
    par = np.ascontiguousarray(parity, np.uint8)
    e = np.empty((n, k // 8, w), np.uint8)
    step = max(1, _CHUNK_BYTES // (k * w))

    def run(i0):
        i1 = min(i0 + step, n)
        g = (i1 - i0) * (k // 8)
        _errors(raw[i0:i1].reshape(g, 8, w), par[i0:i1].reshape(g, w),
                e[i0:i1].reshape(g, w))

    if n <= step:
        run(0)
    else:
        for f in [_thread_pool().submit(run, i) for i in range(0, n, step)]:
            f.result()
    return e


def _repair(pages: np.ndarray, e: np.ndarray):
    """Flip the single-bit data errors the error bytes ``e`` name, in
    place. Returns the dirty codewords' (page, group, column) indices and
    which of them are uncorrectable."""
    flat = e.reshape(-1)
    if flat.size % 8 == 0:
        # scan 8 error bytes at a time: almost every codeword is clean
        words = np.flatnonzero(flat.view(np.uint64))
        cand = (words[:, None] * 8 + np.arange(8)).reshape(-1)
        hits = cand[flat[cand] != 0]
    else:
        hits = np.flatnonzero(flat)
    p, rem = np.divmod(hits, e.shape[1] * e.shape[2])
    g, col = np.divmod(rem, e.shape[2])
    s = e[p, g, col] & 0x7F
    dq = _PAR8[e[p, g, col]].astype(bool)
    byte = np.where(dq, _SYN_BYTE[s], 8)
    hit = byte < 8
    # dq == 1: correctable iff the syndrome names a data position, a
    # parity position (power of two) or 0 (overall-bit flip);
    # dq == 0 and syndrome != 0: a double error
    bad = (~dq & (s != 0)) | (dq & ~hit & ~_POW2_OR_0[s])
    pages[p[hit], 8 * g[hit] + byte[hit], col[hit]] ^= _SYN_MASK[s[hit]]
    return (p, g, col), bad


def check_and_correct_pages(pages: np.ndarray, parity: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``check_and_correct_np`` over a batch of pages at once: (n, K, N)
    uint8 and (n, K//8, N) parity -> (corrected (n, K, N), dirty
    (n, K//8, N), uncorrectable (n, K//8, N)), each page exactly what the
    per-page call gives."""
    corrected = np.array(pages, np.uint8, copy=True, order="C")
    e = page_errors(corrected, parity)
    idx, bad = _repair(corrected, e)
    uecc = np.zeros(e.shape, bool)
    uecc[idx] = bad
    return corrected, e != 0, uecc


def check_and_correct_np(raw_bytes: np.ndarray, parity: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (numpy) ``check_and_correct``: the counterpart of the
    reference's ``check_and_correct_np``, with its contract and shapes.
    raw_bytes (K, N) uint8, parity (K//8, N) uint8 -> (corrected (K, N)
    uint8, dirty (K//8, N) bool, uncorrectable (K//8, N) bool)."""
    return tuple(a[0] for a in check_and_correct_pages(
        np.asarray(raw_bytes)[None], np.asarray(parity)[None]))


def correct_pages_(pages: np.ndarray, parity: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Verify (n, K, N) uint8 pages against their (n, K//8, N) parity and
    repair the correctable codewords IN PLACE: the store's armed read.
    Returns (dirty (n,) bool: any codeword flagged, uncorrectable (n,)
    int: codewords flagged uncorrectable) — per page what
    ``check_and_correct_np`` gives, and ``pages`` then hold its
    ``corrected``."""
    if not pages.flags.c_contiguous or pages.dtype != np.uint8:
        raise ValueError("correct_pages_ needs contiguous uint8 pages")
    (p, _, _), bad = _repair(pages, page_errors(pages, parity))
    n = pages.shape[0]
    dirty = np.zeros((n,), bool)
    dirty[p] = True
    return dirty, np.bincount(p[bad], minlength=n)


def weights_to_bytes(w_int8: torch.Tensor) -> torch.Tensor:
    return w_int8.view(torch.uint8)


def bytes_to_weights(b_uint8: torch.Tensor) -> torch.Tensor:
    return b_uint8.view(torch.int8)


# --- RBER injection ---------------------------------------------------------

def flip_sites(nbytes: int, rber: float, seed: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """The bit flips ``inject_bit_errors_np`` applies to ``nbytes`` bytes,
    merged per byte: (byte indices, XOR masks uint8, flipped bit count).
    The same generator calls as the JAX package, so the same positions."""
    rng = np.random.default_rng(seed)
    nbits = nbytes * 8
    nflip = int(rng.binomial(nbits, rber))
    if not nflip:
        return np.zeros((0,), np.int64), np.zeros((0,), np.uint8), 0
    pos = rng.choice(nbits, size=nflip, replace=False)
    idx, inv = np.unique(pos // 8, return_inverse=True)
    masks = np.zeros(idx.shape, np.uint8)
    np.bitwise_xor.at(masks, inv, (1 << (pos % 8)).astype(np.uint8))
    return idx.astype(np.int64), masks, nflip


def inject_bit_errors_np(raw_bytes: np.ndarray, rber: float, seed: int
                         ) -> tuple[np.ndarray, int]:
    """Flip each bit independently with probability ``rber`` (numpy).

    Returns (corrupted_bytes, n_flipped_bits). Deterministic in ``seed``.
    """
    out = raw_bytes.copy()
    idx, masks, nflip = flip_sites(out.size, rber, seed)
    flat = out.reshape(-1)
    flat[idx] ^= masks.astype(out.dtype)
    return out, nflip


def inject_bit_errors_(raw_bytes: torch.Tensor, rber: float, seed: int) -> int:
    """``inject_bit_errors_np`` applied IN PLACE to a contiguous uint8
    tensor on any device: the positions are drawn on the host (numpy), only
    the flipped bytes move. Returns the flipped bit count."""
    if not raw_bytes.is_contiguous() or raw_bytes.dtype != torch.uint8:
        raise ValueError("inject_bit_errors_ needs a contiguous uint8 tensor")
    idx, masks, nflip = flip_sites(raw_bytes.numel(), rber, seed)
    if nflip:
        flat = raw_bytes.view(-1)
        i = torch.from_numpy(idx).to(raw_bytes.device)
        flat[i] = flat[i] ^ torch.from_numpy(masks).to(raw_bytes.device)
    return nflip
