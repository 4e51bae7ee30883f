"""Tiered weight placement (paper contribution C1) — the port of
``repro/core/tiering.py`` (``PagedWeight`` and the page store come with the
streamed planes, in a later slice).

NVLLM stores FFN weights and the final output projection in 3D NAND flash
and keeps attention Q/K/V/O weights, embeddings and norms in DRAM (§3.5).
The flash tier is ``FlashWeight``: INT8 codewords + Hamming(72,64) parity
planes + per-channel scales. ``deploy`` converts a param tree (nested dicts
of tensors) into that tiered form — the "flash programming" step — with
optional RBER injection emulating raw NAND reads. Given the same params,
rber and seed, q, parity and scale are byte-identical to the JAX deploy.
"""
from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Any

import torch

from repro_torch.core import ecc
from repro_torch.core.quant import quantize_int8

FLASH = "flash"
DRAM = "dram"

# Paper placement: FFN + final output projection -> flash; attention
# Q/K/V/O, embeddings, norms -> DRAM. Strict weight-name matches: a
# stacked 1-D param (L, D) must never be mistaken for a (K, N) matrix.
DEFAULT_FLASH_PATTERNS = (
    r".*lm_head$",
    r".*(w_gate|w_up|w_down|w_in|w_out)$",     # FFN / MoE expert banks
    r".*mix/w_in_[xy]$", r".*mix/w_out$",      # RG-LRU recurrent projections
    r".*tmix/w_[rkvgo]$",                      # RWKV time-mix projections
    r".*channel_mix/w_rgate$",
)


@dataclasses.dataclass
class FlashWeight:
    """A flash-tier weight matrix: raw INT8 pages + parity + dequant scale.
    Leading dims, where present, are the layer stack."""
    q: torch.Tensor        # (..., K, N) int8 raw codeword bytes (as weights)
    parity: torch.Tensor   # (..., K//8, N) uint8
    scale: torch.Tensor    # (..., 1, N) float32

    def __getitem__(self, i) -> "FlashWeight":
        """Index the leading (layer) dim of a stacked weight."""
        return FlashWeight(self.q[i], self.parity[i], self.scale[i])

    @property
    def shape(self):
        return tuple(self.q.shape)

    def nbytes(self) -> int:
        return self.q.numel() + self.parity.numel() + self.scale.numel() * 4


def is_flash_path(path: str, patterns=DEFAULT_FLASH_PATTERNS) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


def encode_flash(w: torch.Tensor, rber: float = 0.0, seed: int = 0
                 ) -> FlashWeight:
    """Quantize + ECC-encode one weight matrix (leading dims = layer stack),
    on ``w``'s device. Each (K, N) slice is quantized and encoded on its
    own, so no full-stack f32 temporary exists; the bit errors are drawn
    over the whole stack with one seed, as the JAX version does."""
    if w.ndim < 2:
        raise ValueError("flash tier holds matrices")
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    k, n = flat.shape[-2:]
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    parity = torch.empty((flat.shape[0], k // 8, n), dtype=torch.uint8,
                         device=w.device)
    scale = torch.empty((flat.shape[0], 1, n), dtype=torch.float32,
                        device=w.device)
    for i in range(flat.shape[0]):
        q[i], scale[i] = quantize_int8(flat[i], axis=0)
        parity[i] = ecc.encode(ecc.weights_to_bytes(q[i]))
    if rber > 0.0:
        ecc.inject_bit_errors_(ecc.weights_to_bytes(q), rber, seed)
    lead = tuple(w.shape[:-2])
    return FlashWeight(q=q.reshape(w.shape),
                       parity=parity.reshape(lead + (k // 8, n)),
                       scale=scale.reshape(lead + (1, n)))


def _walk(tree: dict, prefix: str = ""):
    for key, v in tree.items():
        p = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(v, dict):
            yield from _walk(v, p)
        else:
            yield p, v


def deploy(params: dict, patterns=DEFAULT_FLASH_PATTERNS, rber: float = 0.0,
           seed: int = 0) -> tuple[dict, dict[str, str]]:
    """Convert a param tree to tiered NVLLM deployment form.

    Returns (tiered_params, tier_map). Flash-tier leaves become
    ``FlashWeight``s (encoded on the leaf's device); DRAM-tier leaves are
    cast to bf16. Param paths are the JAX package's ("layers/ffn/w_up").
    """
    tier_map: dict[str, str] = {}
    tiered: dict[str, Any] = {}
    for p, leaf in _walk(params):
        flash = is_flash_path(p, patterns) and leaf.ndim >= 2
        tier_map[p] = FLASH if flash else DRAM
        if flash:
            # crc32, not hash(): Python string hashing is randomized per
            # process, and the seed must be the same in every run.
            out = encode_flash(leaf, rber=rber,
                               seed=seed + zlib.crc32(p.encode()) % (2**31))
        else:
            out = leaf.to(torch.bfloat16)
        node = tiered
        *parents, last = p.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = out
    return tiered, tier_map


def flash_bytes(tiered: dict) -> tuple[int, int]:
    """(flash_tier_bytes, dram_tier_bytes) of a deployed tree."""
    fb = db = 0
    for _, leaf in _walk(tiered):
        if isinstance(leaf, FlashWeight):
            fb += leaf.nbytes()
        else:
            db += leaf.numel() * leaf.element_size()
    return fb, db
