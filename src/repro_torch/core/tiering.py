"""Tiered weight placement (paper contribution C1) — the port of
``repro/core/tiering.py``.

NVLLM stores FFN weights and the final output projection in 3D NAND flash
and keeps attention Q/K/V/O weights, embeddings and norms in DRAM (§3.5).
The flash tier is ``FlashWeight``: INT8 codewords + Hamming(72,64) parity
planes + per-channel scales. ``deploy`` converts a param tree (nested dicts
of tensors) into that tiered form — the "flash programming" step — with
optional RBER injection emulating raw NAND reads. Given the same params,
rber and seed, q, parity and scale are byte-identical to the JAX deploy.
With a ``store`` (``store/pagestore.PageStore``) the flash tier is
serialized into host NAND pages instead and the tree carries ``StoreRef``
placeholders; the streamed engine consumes those pages in place from the
device page pool as ``PagedWeight``s.
"""
from __future__ import annotations

import dataclasses
import math
import re
import zlib
from typing import Any

import numpy as np
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

    def to(self, device) -> "FlashWeight":
        return FlashWeight(self.q.to(device), self.parity.to(device),
                           self.scale.to(device))

    @property
    def shape(self):
        return tuple(self.q.shape)

    def nbytes(self) -> int:
        return self.q.numel() + self.parity.numel() + self.scale.numel() * 4


@dataclasses.dataclass
class PagedWeight:
    """A flash-tier weight consumed IN PLACE from the device page pool: the
    shared ``(n_pages, 16 KiB)`` int8 pool tensor plus the page tables
    naming which pool slots hold this weight's 128x128 q tiles and its flat
    parity and scale byte runs (``store/page_pool.WeightPagePool.upload``
    builds them). ``kn`` is the logical (K, N)."""
    pool: torch.Tensor      # (n_pages, PAGE_BYTES) int8
    q_tbl: torch.Tensor     # (..., k_tiles, n_tiles) i32 pool page slots
    p_slots: torch.Tensor   # (..., n_parity_pages) i32
    s_slots: torch.Tensor   # (..., n_scale_pages) i32
    kn: tuple = ()

    @property
    def lead(self) -> tuple:
        return tuple(self.q_tbl.shape[:-2])

    @property
    def shape(self) -> tuple:
        return self.lead + tuple(self.kn)


def is_flash_path(path: str, patterns=DEFAULT_FLASH_PATTERNS) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


def flash_seed(seed: int, path: str) -> int:
    """The RBER seed of flash leaf ``path``: crc32, not hash(): Python
    string hashing is randomized per process, and the seed must be the
    same in every run."""
    return seed + zlib.crc32(path.encode()) % (2**31)


class FlashEncoder:
    """Encodes a (*lead, K, N) flash leaf one (K, N) matrix at a time into
    its preallocated int8 / uint8 / f32 buffers on ``device``: ``put(i,
    w)`` quantizes and ECC-encodes matrix i (row-major over the lead dims)
    on ``w``'s device and copies the codes into the buffers, ``finish()``
    draws the bit errors over the whole leaf with one seed, as the JAX
    version does, and returns the ``FlashWeight``. No f32 or bf16 copy of
    the stack exists. The buffers may live in host memory while the
    matrices are drawn and encoded on the card (a leaf bound for a host
    page store): the bytes are the same."""

    def __init__(self, shape: tuple, device, rber: float = 0.0,
                 seed: int = 0):
        if len(shape) < 2:
            raise ValueError("flash tier holds matrices")
        self.shape, self.rber, self.seed = tuple(shape), rber, seed
        m, (k, n) = math.prod(shape[:-2]), shape[-2:]
        self.q = torch.empty((m, k, n), dtype=torch.int8, device=device)
        self.parity = torch.empty((m, k // 8, n), dtype=torch.uint8,
                                  device=device)
        self.scale = torch.empty((m, 1, n), dtype=torch.float32,
                                 device=device)

    def put(self, i: int, w: torch.Tensor) -> None:
        q, scale = quantize_int8(w, axis=0)
        self.q[i].copy_(q)
        self.scale[i].copy_(scale)
        self.parity[i].copy_(ecc.encode(ecc.weights_to_bytes(q)))

    def finish(self) -> FlashWeight:
        if self.rber > 0.0:
            ecc.inject_bit_errors_(ecc.weights_to_bytes(self.q), self.rber,
                                   self.seed)
        lead = self.shape[:-2]
        return FlashWeight(q=self.q.reshape(self.shape),
                           parity=self.parity.reshape(
                               lead + self.parity.shape[1:]),
                           scale=self.scale.reshape(
                               lead + self.scale.shape[1:]))


def encode_flash(w: torch.Tensor, rber: float = 0.0, seed: int = 0
                 ) -> FlashWeight:
    """Quantize + ECC-encode one weight matrix (leading dims = layer stack),
    on ``w``'s device, a (K, N) slice at a time (``FlashEncoder``)."""
    enc = FlashEncoder(tuple(w.shape), w.device, rber, seed)
    for i, m in enumerate(w.reshape((-1,) + tuple(w.shape[-2:]))):
        enc.put(i, m)
    return enc.finish()


def _walk(tree: dict, prefix: str = ""):
    """(path, leaf) in sorted key order — JAX's pytree order, so that
    ``deploy(store=)`` programs the store's pages in the reference's order
    and the page tables come out the same."""
    for key in sorted(tree):
        v = tree[key]
        p = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(v, dict):
            yield from _walk(v, p)
        else:
            yield p, v


def deploy(params: dict, patterns=DEFAULT_FLASH_PATTERNS, rber: float = 0.0,
           seed: int = 0, store=None) -> tuple[dict, dict[str, str]]:
    """Convert a param tree to tiered NVLLM deployment form.

    Returns (tiered_params, tier_map). Flash-tier leaves become
    ``FlashWeight``s (encoded on the leaf's device); DRAM-tier leaves are
    cast to bf16. A leaf that is a ``FlashWeight`` already (``deploy_init``'s)
    is flash tier and passes through as it is, and so does a ``StoreRef``
    (a leaf ``deploy_init`` programmed into ``store`` already). Param
    paths are the JAX package's ("layers/ffn/w_up"). With ``store`` each
    flash leaf is programmed into the store's pages (``put_param``), in
    sorted path order, and replaced by its ``StoreRef``, so device memory
    holds the DRAM tier plus one encoded leaf at a time.
    """
    tier_map: dict[str, str] = {}
    tiered: dict[str, Any] = {}
    for p, leaf in _walk(params):
        programmed = getattr(leaf, "is_store_ref", False)
        encoded = isinstance(leaf, FlashWeight)
        flash = (programmed or encoded
                 or (is_flash_path(p, patterns) and leaf.ndim >= 2))
        tier_map[p] = FLASH if flash else DRAM
        if programmed:
            out = leaf
        elif flash:
            out = leaf if encoded else encode_flash(
                leaf, rber=rber, seed=flash_seed(seed, p))
            if store is not None:
                out = store.put_param(p, out)
        else:
            out = leaf.to(torch.bfloat16)
        node = tiered
        *parents, last = p.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = out
    return tiered, tier_map


def deploy_init(cfg, generator: torch.Generator, rber: float = 0.0,
                seed: int = 0, store=None, device="cuda"
                ) -> tuple[dict, dict[str, str]]:
    """``deploy(family_module(cfg.family).init(cfg, generator, device),
    rber=rber, seed=seed, store=store)``, the same tiered tree, tier map
    and store pages, with every flash-tier (K, N) matrix of a dense- or
    moe-family model quantized and ECC-encoded as it is drawn (the
    family's ``init`` hands it to a ``FlashEncoder``): no flash leaf ever
    exists in bf16, so the peak is about the tiered bytes, not the bf16
    tree's beside them (qwen3-moe-30b-a3b: 56.9 GiB of bf16 against 30.8
    of tier).

    - The bit errors are drawn over each whole stacked leaf with one seed
      (``flash_seed``), after its last matrix is encoded
      (``FlashEncoder.finish``), as ``encode_flash`` draws them.
    - Without a store the encoded leaves are made on ``device``. With one,
      a leaf bound for the host pages is encoded on ``device`` into host
      memory, so the device never holds the tier.
    - The generator draws a MoE layer's router, w_gate, w_up, w_down, but
      a store is programmed in sorted path order (``_walk``: w_down
      first). The encoded leaves are kept until ``init`` returns and then
      programmed in that order, so page ids are ``deploy(store=)``'s; each
      leaves memory once the store holds it.
    - Attention is DRAM tier and drawn whole, bf16: the dense family's
      Algorithm 2 flash copies (``program_attn_flash``, the engine's) are
      encoded from it.

    The other families stack whole layers in their ``init``
    (``common.stack_layers``): they are drawn whole and deployed."""
    from repro_torch.models import family_module

    held = device if store is None else "cpu"

    def sink(path: str, shape: tuple):
        if is_flash_path(path) and len(shape) >= 2:
            return FlashEncoder(shape, held, rber, flash_seed(seed, path))
        return None

    kw = dict(sink=sink) if cfg.family in ("dense", "moe") else {}
    params = family_module(cfg.family).init(cfg, generator, device=device,
                                            **kw)
    if store is not None:
        # the only reference to each encoded leaf is its node's: replaced
        # by its StoreRef, the leaf is freed before the next is programmed
        encoded = [p for p, leaf in _walk(params)
                   if isinstance(leaf, FlashWeight)]
        for p in encoded:
            *parents, last = p.split("/")
            node = params
            for key in parents:
                node = node[key]
            node[last] = store.put_param(p, node[last])
    return deploy(params, rber=rber, seed=seed, store=store)


def tile_parity(parity: np.ndarray, k_tile: int, n_tile: int,
                tile: int = 128) -> np.ndarray:
    """The parity slice protecting ONE (tile, tile) q page of a flash
    param: rows ``k_tile*tile/8 .. +tile/8``, cols ``n_tile*tile .. +tile``
    of the (K//8, N) parity plane, zero-padded to the full page grid.

    Valid because codewords are local to 8-row groups within a column and
    the page grid pads K/N up to tile multiples: K and the tile are
    multiples of 8, so no codeword straddles real and padded rows, and the
    parity byte of an all-zero padded codeword is 0. The PageStore's
    read-retry path verifies pages host-side with it."""
    rows = tile // 8
    out = np.zeros((rows, tile), np.uint8)
    pr = parity[k_tile * rows:(k_tile + 1) * rows,
                n_tile * tile:(n_tile + 1) * tile]
    out[:pr.shape[0], :pr.shape[1]] = pr
    return out


def page_parities(parity: np.ndarray, grid: tuple, tile: int = 128
                  ) -> np.ndarray:
    """``tile_parity`` of every page of a (kt, nt) q grid at once, in the
    page table's tile-row-major order: (kt * nt, tile // 8, tile)."""
    kt, nt = grid
    rows = tile // 8
    padded = np.zeros((kt * rows, nt * tile), np.uint8)
    padded[:parity.shape[0], :parity.shape[1]] = parity
    return np.ascontiguousarray(padded.reshape(kt, rows, nt, tile)
                                .transpose(0, 2, 1, 3)
                                .reshape(kt * nt, rows, tile))


# Per-layer flash Q/K/V/O copies (Algorithm 2's in-flash projection
# targets), programmed into a store under ``attn_flash/{key}@{layer}``. The
# engine dispatches only wq and wo; wk and wv are programmed (and streamed)
# as the reference does, so store bytes, page tables and die images are the
# JAX package's.
ATTN_FLASH_KEYS = ("wq", "wk", "wv", "wo")


def program_attn_flash(store, attn_layers: dict, n_layers: int,
                       rber: float = 0.0, seed: int = 0) -> None:
    """Program the per-layer attn flash copies into ``store``, encoded as
    the resident engine's flash copies are (per-layer seed ``seed + li``)."""
    for li in range(n_layers):
        for k in ATTN_FLASH_KEYS:
            store.put(f"attn_flash/{k}@{li}",
                      encode_flash(attn_layers[k][li], rber=rber,
                                   seed=seed + li))


def dram_tier(params: dict, patterns=DEFAULT_FLASH_PATTERNS) -> dict:
    """The DRAM-tier remainder of a raw param tree without encoding the
    flash tier: flash-pattern matrices dropped, everything else cast to
    bf16 — the same tree as ``drop_store_refs(deploy(params, store=...))``,
    the params an engine over a programmed die image takes."""
    def rec(tree, prefix):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = rec(v, p)
            elif not (is_flash_path(p, patterns) and v.ndim >= 2):
                out[k] = v.to(torch.bfloat16)
        return out
    return rec(params, "")


def init_template(cfg) -> dict:
    """The family's ``init`` tree for ``cfg`` on the meta device: shapes
    and dtypes with no memory and no numbers drawn, a restore's template
    (``CheckpointManager.restore`` reads its leaves for their place only).
    A real draw at qwen3-moe-30b-a3b's 48 layers makes 56.9 GiB of bf16
    to throw away."""
    from repro_torch.models import family_module

    return family_module(cfg.family).init(cfg, torch.Generator(),
                                          device="meta")


def flash_bytes(tiered: dict) -> tuple[int, int]:
    """(flash_tier_bytes, dram_tier_bytes) of a deployed tree, with
    FlashWeight leaves or store-resident StoreRef placeholders."""
    fb = db = 0
    for _, leaf in _walk(tiered):
        if isinstance(leaf, FlashWeight):
            fb += leaf.nbytes()
        elif getattr(leaf, "is_store_ref", False):
            fb += leaf.nbytes
        else:
            db += leaf.numel() * leaf.element_size()
    return fb, db
