"""FlashStore page store: the flash tier as host-resident 16 KiB NAND pages —
the port of ``repro/store/pagestore.py`` (unsharded; no fault plane).

A deployed ``FlashWeight`` (raw INT8 codeword bytes + Hamming parity +
dequant scales) is serialized into a PLANE-INTERLEAVED array of 16 KiB
pages: page ``pid`` lives on plane ``pid % n_planes``, so consecutive tiles
of one parameter stripe across planes and a full-parameter read engages
every plane.

The page table maps ``(param, k_tile, n_tile) -> (plane, page)`` for the
128x128 INT8 weight tiles (one tile == one page); parity and scale planes
ride along as flat page runs per parameter. Stacked (L, K, N) params are
split per layer at ``put_param`` (entries ``name@li``) so the streamed
engine can fetch one layer group's pages without touching the rest.

The store is host numpy. ``save``/``open`` persist it as a raw die image +
JSON page table in the JAX package's format: an image either package
writes opens in the other, page for page. Reads count pages per plane;
``nand_seconds`` turns the counters into analytical array time.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.tiering import FlashWeight
from repro_torch.store import nand

PAGE_BYTES = nand.PAGE_BYTES
TILE = 128                       # 128x128 int8 tile == one 16 KiB page


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class StoreRef:
    """Placeholder leaf for a flash param that lives in a PageStore.

    ``deploy(store=...)`` returns these in place of FlashWeights; only the
    streamed serving engine dereferences them. ``lead`` is the stacked
    leading shape ((L,) for layer-stacked params), split into per-slice
    store entries named ``{name}@{i[.j...]}``.
    """
    name: str
    shape: tuple                 # full logical q shape, leading dims included
    nbytes: int                  # stored payload bytes (q + parity + scale)
    lead: tuple = ()

    is_store_ref = True

    def entry(self, *idx: int) -> str:
        """Store entry name of one stacked slice (no idx = unstacked)."""
        if not idx:
            return self.name
        return f"{self.name}@{'.'.join(str(i) for i in idx)}"


def drop_store_refs(tree):
    """A dict tree minus its StoreRef leaves — the DRAM-resident remainder
    after ``deploy(store=...)``."""
    if isinstance(tree, dict):
        return {k: drop_store_refs(v) for k, v in tree.items()
                if not getattr(v, "is_store_ref", False)}
    return tree


def graft_store_refs(tree, refs: dict) -> dict:
    """Insert ``refs`` ('/'-joined param path -> StoreRef) into a DRAM-tier
    tree — the inverse of ``drop_store_refs`` for a store opened from a die
    image."""
    out = {k: (graft_store_refs(v, {}) if isinstance(v, dict) else v)
           for k, v in tree.items()}
    for path, ref in refs.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = ref
    return out


@dataclasses.dataclass
class _Component:
    """One serialized array of a parameter (q / parity / scale)."""
    shape: tuple
    dtype: str
    pages: list                  # page ids, tile-row-major (q) or flat runs
    grid: tuple = ()             # (k_tiles, n_tiles) — q only

    def to_json(self):
        return {"shape": list(self.shape), "dtype": self.dtype,
                "pages": [int(p) for p in self.pages],
                "grid": list(self.grid)}

    @classmethod
    def from_json(cls, d):
        return cls(tuple(d["shape"]), d["dtype"], list(d["pages"]),
                   tuple(d["grid"]))


def _host(t) -> np.ndarray:
    """A tensor (any device) or array as host numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class PageStore:
    """Host-resident, page-granular store for the flash weight tier."""

    def __init__(self, n_planes: int = nand.N_PLANES,
                 page_bytes: int = PAGE_BYTES, n_shards: int = 1):
        self.n_planes = int(n_planes)
        if page_bytes != TILE * TILE:
            raise ValueError(f"page_bytes must be {TILE * TILE} "
                             f"(one {TILE}x{TILE} int8 tile per page)")
        # the shard layout an image is stamped with (save/open); validated
        # against the plane-group count as the reference does
        nand.shard_planes(self.n_planes, int(n_shards))
        self.n_shards = int(n_shards)
        self.page_bytes = int(page_bytes)
        self.table: dict[str, dict[str, _Component]] = {}
        self._data = np.zeros((0, self.page_bytes), np.uint8)
        self.n_pages = 0
        self.total_bytes = 0         # logical payload bytes across entries
        # reads come from the streamer's worker thread and the engine's
        # init; the counters are the only shared mutable state on the path
        self._read_lock = threading.Lock()
        self.reset_counters()

    # --- write path (deploy-time "flash programming"; write-once) -----------

    def _alloc_pages(self, n: int) -> np.ndarray:
        if isinstance(self._data, np.memmap):
            raise ValueError("store opened from a die image is read-only "
                             "(NAND programming is write-once)")
        if self.n_pages + n > len(self._data):
            cap = max(64, 2 * len(self._data), self.n_pages + n)
            grown = np.zeros((cap, self.page_bytes), np.uint8)
            grown[:self.n_pages] = self._data[:self.n_pages]
            self._data = grown
        ids = np.arange(self.n_pages, self.n_pages + n, dtype=np.int64)
        self.n_pages += n
        return ids

    def _put_flat(self, arr: np.ndarray) -> _Component:
        """Serialize an array as a flat byte run over whole pages."""
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        ids = self._alloc_pages(_cdiv(raw.size, self.page_bytes))
        for i, pid in enumerate(ids):
            chunk = raw[i * self.page_bytes:(i + 1) * self.page_bytes]
            self._data[pid, :chunk.size] = chunk
        return _Component(tuple(arr.shape), str(arr.dtype), ids.tolist())

    def _put_tiled(self, q: np.ndarray) -> _Component:
        """Serialize a (K, N) int8 matrix as 128x128 tiles, one per page."""
        k, n = q.shape
        kt, nt = _cdiv(k, TILE), _cdiv(n, TILE)
        padded = np.zeros((kt * TILE, nt * TILE), np.int8)
        padded[:k, :n] = np.asarray(q, np.int8)
        ids = self._alloc_pages(kt * nt)
        tiles = padded.reshape(kt, TILE, nt, TILE).transpose(0, 2, 1, 3)
        self._data[ids] = tiles.reshape(kt * nt, TILE * TILE).view(np.uint8)
        return _Component((k, n), "int8", ids.tolist(), grid=(kt, nt))

    def put(self, name: str, fw: FlashWeight) -> None:
        """Program ONE 2-D FlashWeight (tensors on any device, or numpy)
        into pages under ``name``."""
        if name in self.table:
            raise ValueError(f"store entry {name!r} already programmed "
                             "(NAND programming is write-once)")
        if fw.q.ndim != 2:
            raise ValueError("put() takes a single (K, N) FlashWeight; "
                             "use put_param() for stacked params")
        q, parity, scale = _host(fw.q), _host(fw.parity), _host(fw.scale)
        self.table[name] = {
            "q": self._put_tiled(q),
            "parity": self._put_flat(parity.astype(np.uint8, copy=False)),
            "scale": self._put_flat(scale.astype(np.float32, copy=False)),
        }
        self.total_bytes += q.size + parity.size + scale.size * 4

    def put_param(self, name: str, fw: FlashWeight) -> StoreRef:
        """Program a (possibly layer-stacked) FlashWeight; returns the
        StoreRef placeholder that replaces it in the deployed tree."""
        lead = tuple(int(d) for d in fw.q.shape[:-2])
        ref = StoreRef(name=name, shape=tuple(int(d) for d in fw.q.shape),
                       nbytes=fw.nbytes(), lead=lead)
        q, parity, scale = _host(fw.q), _host(fw.parity), _host(fw.scale)
        for idx in np.ndindex(lead) if lead else [()]:
            self.put(ref.entry(*idx),
                     FlashWeight(q=q[idx], parity=parity[idx],
                                 scale=scale[idx]))
        return ref

    # --- read path (page-granular, plane-counted) ---------------------------

    def reset_counters(self):
        self.plane_reads = np.zeros((self.n_planes,), np.int64)
        self.pages_read = 0
        self.bytes_read = 0

    def plane_of(self, pid: int) -> tuple[int, int]:
        """Physical (plane, page-in-plane) of a global page id."""
        return int(pid) % self.n_planes, int(pid) // self.n_planes

    def page_of(self, name: str, k_tile: int, n_tile: int) -> tuple[int, int]:
        """The page-table lookup: (param, k_tile, n_tile) -> (plane, page)."""
        comp = self.table[name]["q"]
        kt, nt = comp.grid
        if not (0 <= k_tile < kt and 0 <= n_tile < nt):
            raise IndexError(f"tile ({k_tile}, {n_tile}) outside grid "
                             f"{comp.grid}")
        return self.plane_of(comp.pages[k_tile * nt + n_tile])

    def read_pages(self, ids, out: np.ndarray | None = None) -> np.ndarray:
        """Raw page reads (len(ids), page_bytes) — counts per-plane traffic.
        ``out`` reads straight into a caller-owned (staging) buffer."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_pages):
            raise IndexError(f"page ids outside the store's {self.n_pages}")
        with self._read_lock:
            np.add.at(self.plane_reads, ids % self.n_planes, 1)
            self.pages_read += ids.size
            self.bytes_read += ids.size * self.page_bytes
        if out is None:
            return self._data[ids]
        # mode="clip" (the ids are checked above): with the default "raise"
        # numpy takes into a fresh copy of ``out`` and copies it back
        np.take(self._data, ids, axis=0, out=out, mode="clip")
        return out

    def _get_flat(self, comp: _Component) -> np.ndarray:
        raw = self.read_pages(comp.pages).reshape(-1)
        n = int(np.prod(comp.shape)) * np.dtype(comp.dtype).itemsize
        return raw[:n].view(comp.dtype).reshape(comp.shape).copy()

    def _get_tiled(self, comp: _Component) -> np.ndarray:
        kt, nt = comp.grid
        tiles = self.read_pages(comp.pages).view(np.int8)
        padded = tiles.reshape(kt, nt, TILE, TILE).transpose(0, 2, 1, 3)
        k, n = comp.shape
        return padded.reshape(kt * TILE, nt * TILE)[:k, :n].copy()

    def get_host(self, name: str) -> dict[str, np.ndarray]:
        """Read one entry back as host numpy arrays (bit-exact)."""
        e = self.table[name]
        return {"q": self._get_tiled(e["q"]),
                "parity": self._get_flat(e["parity"]),
                "scale": self._get_flat(e["scale"])}

    def get(self, name: str, device="cuda") -> FlashWeight:
        """One entry as a ``FlashWeight`` of tensors on ``device``."""
        h = self.get_host(name)
        return FlashWeight(q=torch.from_numpy(h["q"]).to(device),
                           parity=torch.from_numpy(h["parity"]).to(device),
                           scale=torch.from_numpy(h["scale"]).to(device))

    def entry_pages(self, name: str) -> int:
        return sum(len(c.pages) for c in self.table[name].values())

    def entry_nbytes(self, name: str) -> int:
        e = self.table[name]
        return (int(np.prod(e["q"].shape))
                + int(np.prod(e["parity"].shape))
                + int(np.prod(e["scale"].shape)) * 4)

    def param_refs(self, exclude_prefixes: tuple = ()) -> dict[str, StoreRef]:
        """Rebuild the ``StoreRef`` placeholders from the page table — the
        inverse of ``put_param`` for a store opened from a die image.
        Entries ``base@i[.j...]`` group into one stacked ref per base name;
        ``exclude_prefixes`` drops engine-internal entries (the
        ``attn_flash/`` per-layer copies, addressed by name)."""
        groups: dict[str, dict[tuple, str]] = {}
        for entry in self.table:
            base, sep, idx = entry.partition("@")
            if any(base.startswith(p) for p in exclude_prefixes):
                continue
            key = tuple(int(i) for i in idx.split(".")) if sep else ()
            groups.setdefault(base, {})[key] = entry
        refs: dict[str, StoreRef] = {}
        for base, entries in groups.items():
            lead = ()
            if () not in entries:
                lead = tuple(d + 1 for d in
                             np.max(np.array(list(entries)), axis=0))
                if int(np.prod(lead)) != len(entries):
                    raise ValueError(
                        f"store entries for {base!r} do not form a dense "
                        f"{lead} stack ({len(entries)} present)")
            slice_shape = self.table[entries[min(entries)]]["q"].shape
            refs[base] = StoreRef(
                name=base, shape=lead + tuple(slice_shape),
                nbytes=sum(self.entry_nbytes(e) for e in entries.values()),
                lead=lead)
        return refs

    # --- accounting ---------------------------------------------------------

    @property
    def image_bytes(self) -> int:
        return self.n_pages * self.page_bytes

    def nand_seconds(self) -> float:
        """Analytical NAND array time for all reads since reset_counters."""
        return nand.nand_read_seconds(self.plane_reads)

    def stats(self) -> dict[str, Any]:
        return {"entries": len(self.table), "pages": self.n_pages,
                "planes": self.n_planes, "image_bytes": self.image_bytes,
                "payload_bytes": self.total_bytes,
                "pages_read": int(self.pages_read),
                "bytes_read": int(self.bytes_read),
                "nand_seconds": self.nand_seconds()}

    # --- NAND die image (mmap backing) --------------------------------------

    def save(self, path: str, n_shards: int | None = None) -> None:
        """Persist the die image (raw pages) + page table (JSON sidecar),
        in the JAX package's format. ``n_shards`` stamps the shard layout
        the image is meant for; it must divide the plane count."""
        if n_shards is None:
            n_shards = self.n_shards
        nand.shard_planes(self.n_planes, int(n_shards))
        self._data[:self.n_pages].tofile(path)
        meta = {
            "page_bytes": self.page_bytes, "n_planes": self.n_planes,
            "n_pages": self.n_pages, "total_bytes": self.total_bytes,
            "n_shards": int(n_shards),
            "table": {name: {c: comp.to_json() for c, comp in e.items()}
                      for name, e in self.table.items()},
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    @classmethod
    def open(cls, path: str, n_shards: int | None = None) -> "PageStore":
        """mmap an existing die image read-only: pages stay on disk until
        read. An image stamped for another shard count than ``n_shards``
        is refused (an unsharded image serves any)."""
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        saved = int(meta.get("n_shards", 1))
        if n_shards is not None and saved != 1 and saved != int(n_shards):
            raise ValueError(
                f"die image {path} was saved for n_shards={saved} but the "
                f"requested mesh has n_shards={int(n_shards)}")
        self = cls(n_planes=meta["n_planes"], page_bytes=meta["page_bytes"],
                   n_shards=(int(n_shards) if n_shards is not None
                             else saved))
        self.n_pages = meta["n_pages"]
        self.total_bytes = meta["total_bytes"]
        self.table = {name: {c: _Component.from_json(d)
                             for c, d in e.items()}
                      for name, e in meta["table"].items()}
        expect = self.n_pages * self.page_bytes
        if os.path.getsize(path) != expect:
            raise ValueError(f"die image {path} is {os.path.getsize(path)} "
                             f"bytes, page table says {expect}")
        self._data = np.memmap(path, np.uint8, mode="r",
                               shape=(self.n_pages, self.page_bytes))
        return self
