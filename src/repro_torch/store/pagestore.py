"""FlashStore page store: the flash tier as host-resident 16 KiB NAND pages —
the port of ``repro/store/pagestore.py``.

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

For tensor-parallel streamed serving, ``shard_entry`` partitions one
entry's tiles round-robin over the "model" shards (``ShardPlan``) and
``shard_host_slices`` cuts its parity and scale runs to follow them.

The fault plane (``attach_injector``): with a ``faults.FaultInjector``
armed, every read of an ECC-protected q page is perturbed by the injector,
verified on the host against its parity (SEC-DED, ``core.ecc``), retried
when uncorrectable, and escalated past the retry budget — relocated into a
fresh page of a writable store, or served from the DRAM-tier good copy of
a read-only die image. Corrected bytes land in the caller's buffer, so a
reader (the page pool's staging rows) only ever sees verified pages. The
verify runs batched over a read's pages; which pages are retried, how
often, in which order the injector's per-page nonces advance and which
page ids a relocation takes are the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import ecc
from repro_torch.core.tiering import FlashWeight, page_parities
from repro_torch.obs.registry import Sample
from repro_torch.obs.trace import TID_NAND, default_tracer
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


def shard_tiles(grid: tuple, n_shards: int, axis: int):
    """Round-robin partition of a (kt, nt) q-tile grid along ``axis``:
    tile column (axis=1) or row (axis=0) ``c`` goes to shard ``c %
    n_shards``, so consecutive tiles of one param stripe across shards as
    pages stripe across planes. Returns (per-shard flat tile-index arrays
    in LOCAL row-major order, the local (kt, nt) grid). Raises when the
    axis is not divisible (the caller replicates instead)."""
    kt, nt = grid
    if axis not in (0, 1):
        raise ValueError(f"shard axis must be 0 or 1, got {axis}")
    if grid[axis] % n_shards:
        raise ValueError(
            f"grid {grid} axis {axis} ({grid[axis]} tiles) is not "
            f"divisible by n_shards={n_shards}")
    flat = np.arange(kt * nt).reshape(kt, nt)
    if axis == 1:
        parts = [flat[:, s::n_shards].reshape(-1) for s in range(n_shards)]
        local = (kt, nt // n_shards)
    else:
        parts = [flat[s::n_shards, :].reshape(-1) for s in range(n_shards)]
        local = (kt // n_shards, nt)
    return parts, local


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How ONE store entry splits across ``n_shards`` pool partitions.

    ``axis`` None = replicated (every shard stages the whole entry);
    otherwise the q grid round-robins tile columns (axis=1, the N / d_ff
    axis of w_gate / w_up) or tile rows (axis=0, the K axis of w_down),
    and the parity / scale runs follow their tiles. ``q_pages[s]`` are
    GLOBAL store page ids in shard ``s``'s local row-major order."""
    axis: int | None
    n_shards: int
    kn: tuple                     # full logical (K, N)
    local_kn: tuple               # per-shard logical (K, N)
    local_grid: tuple             # per-shard (kt, nt)
    q_pages: tuple                # per-shard arrays of global page ids
    parity_nbytes: int            # per-shard parity payload bytes
    scale_nbytes: int             # per-shard scale payload bytes

    @property
    def local_payload_bytes(self) -> int:
        """Per-shard payload (q + parity + scale)."""
        k, n = self.local_kn
        return k * n + self.parity_nbytes + self.scale_nbytes


@dataclasses.dataclass
class _Component:
    """One serialized array of a parameter (q / parity / scale)."""
    shape: tuple
    dtype: str
    pages: list                  # page ids, tile-row-major (q) or flat runs
    grid: tuple = ()             # (k_tiles, n_tiles) — q only

    @property
    def nbytes(self) -> int:
        """The array's payload bytes (its pages hold them, padded)."""
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize

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
        # the fault plane: disarmed (None), reads take the plain fast path
        self.injector = None
        self.max_read_retries = 3
        self._page_owner: dict[int, tuple[str, int]] = {}
        self._prow = np.zeros((0,), np.int64)     # pid -> parity row, -1
        self._fparity = np.zeros((0, TILE // 8, TILE), np.uint8)
        self._fbase = np.zeros((0,), np.int64)    # baseline uecc per row
        self._degraded: set[int] = set()
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
        # fault-plane counters (all stay zero while no injector is armed)
        self.plane_uecc = np.zeros((self.n_planes,), np.int64)
        self.plane_retries = np.zeros((self.n_planes,), np.int64)
        self.plane_relocations = np.zeros((self.n_planes,), np.int64)
        self.uecc_detected = 0
        self.read_retries = 0
        self.retry_corrected = 0
        self.ecc_corrected_pages = 0
        self.relocations = 0
        self.dram_fallback_reads = 0
        # the armed reads' host verify: pages and seconds (the verify rate;
        # not in ``stats()``, whose keys are the reference's)
        self.pages_verified = 0
        self.verify_s = 0.0

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
        ``out`` reads straight into a caller-owned (staging) buffer. With
        a ``FaultInjector`` armed (``attach_injector``) the read runs the
        fault plane (module docstring); disarmed, the plain fast path."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_pages):
            raise IndexError(f"page ids outside the store's {self.n_pages}")
        with self._read_lock:
            np.add.at(self.plane_reads, ids % self.n_planes, 1)
            self.pages_read += ids.size
            self.bytes_read += ids.size * self.page_bytes
        tracer = default_tracer()
        t0 = time.perf_counter() if tracer.enabled else 0.0
        if self.injector is not None:
            res = self._read_pages_faulty(ids, out)
        elif out is None:
            res = self._data[ids]
        else:
            # mode="clip" (the ids are checked above): with the default
            # "raise" numpy takes into a fresh copy of ``out`` and copies
            # it back
            np.take(self._data, ids, axis=0, out=out, mode="clip")
            res = out
        if tracer.enabled and ids.size:
            # the trace's NAND track: this batch's analytical array time
            # beside its host wall time
            counts = np.bincount(ids % self.n_planes,
                                 minlength=self.n_planes)
            tracer.complete("nand.read_pages", t0,
                            time.perf_counter() - t0, tid=TID_NAND,
                            args={"pages": int(ids.size),
                                  "planes_hit": int((counts > 0).sum()),
                                  "nand_s": float(
                                      nand.nand_read_seconds(counts))})
        return res

    # --- fault plane --------------------------------------------------------

    def attach_injector(self, injector, max_read_retries: int = 3) -> None:
        """Arm read-time fault injection and the ECC read-retry /
        relocation path. Call after programming: the protected-page maps
        (per-page parity slices, page -> entry ownership, each page's
        baseline uncorrectable count) are built here from the page table.
        ``attach_injector(None)`` disarms."""
        self.injector = injector
        self.max_read_retries = int(max_read_retries)
        if injector is not None:
            self._rebuild_fault_maps()

    def _rebuild_fault_maps(self, chunk: int = 4096) -> None:
        """Per-q-page parity slices and ownership, and each page's BASELINE
        uncorrectable-codeword count: program-time rber can bake in dirty
        or even uncorrectable codewords, and only damage ABOVE that
        baseline is read-induced and worth retrying."""
        self._page_owner.clear()
        pids, pars = [], []
        for name, e in self.table.items():
            comp = e["q"]
            pages = np.asarray(comp.pages, np.int64)
            pars.append(page_parities(self._get_flat_raw(e["parity"]),
                                      comp.grid, TILE))
            pids.append(pages)
            for idx, pid in enumerate(comp.pages):
                self._page_owner[int(pid)] = (name, idx)
        pids = np.concatenate(pids) if pids else np.zeros((0,), np.int64)
        self._fparity = (np.concatenate(pars) if pars else
                         np.zeros((0, TILE // 8, TILE), np.uint8))
        self._prow = np.full((self.n_pages,), -1, np.int64)
        self._prow[pids] = np.arange(pids.size)
        self._fbase = np.zeros((pids.size,), np.int64)
        for i in range(0, pids.size, chunk):
            raw = np.array(self._data[pids[i:i + chunk]], np.uint8)
            _, self._fbase[i:i + chunk] = ecc.correct_pages_(
                raw.reshape(-1, TILE, TILE), self._fparity[i:i + chunk])
        self._degraded.clear()

    def _get_flat_raw(self, comp: _Component) -> np.ndarray:
        """A flat component straight off the die: no counters, no fault
        plane (the fault maps are built from it)."""
        raw = np.asarray(self._data[np.asarray(comp.pages, np.int64)]
                         ).reshape(-1)
        n = int(np.prod(comp.shape)) * np.dtype(comp.dtype).itemsize
        return raw[:n].view(comp.dtype).reshape(comp.shape).copy()

    def _verify(self, rows: np.ndarray, pages: np.ndarray):
        """Batched SEC-DED over ``pages`` (n, page_bytes), corrected in
        place against parity rows ``rows``: (dirty (n,), uecc (n,))."""
        t0 = time.perf_counter()
        dirty, uecc = ecc.correct_pages_(pages.reshape(-1, TILE, TILE),
                                         self._fparity[rows])
        with self._read_lock:
            self.pages_verified += len(rows)
            self.verify_s += time.perf_counter() - t0
        return dirty, uecc

    def _read_pages_faulty(self, ids: np.ndarray,
                           out: np.ndarray | None) -> np.ndarray:
        """The armed read path: inject -> verify -> retry -> escalate.

        Only ECC-protected q pages are perturbed and verified (parity and
        scale runs model the controller's stronger metadata code). A page
        that verifies clean or correctable ships its corrected bytes, so
        readers see exactly the fault-free bytes. Detected-uncorrectable
        pages are re-read up to ``max_read_retries`` times (transients
        clear, stuck pages don't), then relocated (writable store) or
        degraded to the DRAM-tier good copy (read-only die image). Every
        page is injected first, in read order, then the read's pages are
        verified at once, then the failures retried in read order: the
        injector's state is per page, so this is the reference's
        page-at-a-time sequence, unless a read names a page twice (then
        it runs page at a time)."""
        inj = self.injector
        inj.pre_read(int(ids.size))
        if out is None:
            buf = np.array(self._data[ids], np.uint8)   # owned, writable
        else:
            np.take(self._data, ids, axis=0, out=out, mode="clip")
            buf = out
        if self._prow.size < self.n_pages:   # pages programmed after attach
            self._grow_prow(self.n_pages)
        rows = self._prow[ids]
        prot = np.flatnonzero(rows >= 0)
        if self._degraded and prot.size:
            # degraded pages are served from the DRAM-tier good copy: the
            # raw (pristine) bytes, never injected nor verified
            deg = np.isin(ids[prot], np.fromiter(self._degraded, np.int64))
            if deg.any():
                with self._read_lock:
                    self.dram_fallback_reads += int(deg.sum())
                prot = prot[~deg]
        if not prot.size:
            return buf
        if np.unique(ids[prot]).size != prot.size:
            for i in prot.tolist():          # a page read twice
                self._read_one(int(ids[i]), buf[i])
            return buf
        for i in prot.tolist():
            inj.corrupt_page(int(ids[i]), buf[i])
        # verified in place, a run of consecutive protected rows at a time
        # (a window's entries: q pages, then parity and scale runs)
        dirty = np.empty((prot.size,), bool)
        uecc = np.empty((prot.size,), np.int64)
        for run in np.split(np.arange(prot.size),
                            np.flatnonzero(np.diff(prot) != 1) + 1):
            a, b = prot[run[0]], prot[run[-1]] + 1
            dirty[run], uecc[run] = self._verify(rows[a:b], buf[a:b])
        base = self._fbase[rows[prot]]
        ok = uecc <= base
        with self._read_lock:
            self.ecc_corrected_pages += int((ok & dirty).sum())
        for j in np.flatnonzero(~ok).tolist():
            i = int(prot[j])
            self._retry_page(int(ids[i]), buf[i])
        return buf

    def _read_one(self, pid: int, row: np.ndarray) -> None:
        """One protected page of an armed read, page at a time."""
        if pid in self._degraded:
            with self._read_lock:
                self.dram_fallback_reads += 1
            return
        self.injector.corrupt_page(pid, row)
        r = self._prow[[pid]]
        dirty, uecc = self._verify(r, row[None])
        if uecc[0] <= self._fbase[r[0]]:
            if dirty[0]:
                with self._read_lock:
                    self.ecc_corrected_pages += 1
            return
        self._retry_page(pid, row)

    def _retry_page(self, pid: int, row: np.ndarray) -> None:
        """Read-retry state machine for ONE detected-uncorrectable page:
        re-read (a fresh transient draw) up to N times; on success ship the
        corrected re-read, on exhaustion escalate (relocate / degrade) and
        ship the DRAM-tier good copy for THIS read either way."""
        inj = self.injector
        plane = pid % self.n_planes
        r = self._prow[[pid]]
        base = self._fbase[r[0]]
        with self._read_lock:
            self.uecc_detected += 1
            self.plane_uecc[plane] += 1
        for _ in range(self.max_read_retries):
            with self._read_lock:
                self.read_retries += 1
                self.plane_retries[plane] += 1
                self.plane_reads[plane] += 1      # a retry is a real read
                self.pages_read += 1
                self.bytes_read += self.page_bytes
            fresh = np.array(self._data[pid], np.uint8)
            inj.corrupt_page(pid, fresh)
            _, uecc = self._verify(r, fresh[None])
            if uecc[0] <= base:
                row[:] = fresh
                with self._read_lock:
                    self.retry_corrected += 1
                return
        # persistent (stuck page): serve the good copy now, then make sure
        # no future read hits this physical page again
        row[:] = self._data[pid]
        if isinstance(self._data, np.memmap):
            with self._read_lock:
                self._degraded.add(pid)
                self.dram_fallback_reads += 1
        else:
            self._relocate(pid)

    def _relocate(self, pid: int) -> None:
        """Re-program a stuck page's tile into a fresh page from the
        DRAM-tier good copy (the pristine programmed bytes: the injector
        only perturbs the read path) and patch the page table, so every
        later fetch reads the new page. Writable stores only; die images
        degrade instead. ``_alloc_pages`` doubles a full array (a copy of
        the whole store, once)."""
        with self._read_lock:
            name, idx = self._page_owner.pop(pid)
            new = int(self._alloc_pages(1)[0])
            self.injector.mark_good(new)      # validated spare block
            self._data[new] = self._data[pid]
            self.table[name]["q"].pages[idx] = new
            self._page_owner[new] = (name, idx)
            if new >= self._prow.size:
                self._grow_prow(max(2 * self._prow.size, new + 1))
            self._prow[new] = self._prow[pid]
            self._prow[pid] = -1
            self.relocations += 1
            self.plane_relocations[pid % self.n_planes] += 1

    def _grow_prow(self, n: int) -> None:
        """Extend the pid -> parity-row map to ``n`` pages; pages with no
        row read unprotected."""
        grown = np.full((n,), -1, np.int64)
        grown[:self._prow.size] = self._prow
        self._prow = grown

    @property
    def degraded_pages(self) -> int:
        return len(self._degraded)

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
        return sum(c.nbytes for c in self.table[name].values())

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

    # --- shard partitioner (tensor-parallel streamed serving) ---------------

    def shard_entry(self, name: str, n_shards: int,
                    axis: int | None) -> ShardPlan:
        """The shard-aware page table of ONE entry: the q grid partitioned
        round-robin along ``axis`` (the parity / scale byte runs follow
        their tiles: the (72, 64) Hamming codewords are local to 8-row
        groups of one column). ``axis`` None, or an axis the shard count
        does not split into whole tiles and whole logical columns / rows,
        replicates the entry on every shard."""
        comp = self.table[name]["q"]
        kt, nt = comp.grid
        k, n = comp.shape
        if axis is not None:
            # a padded edge tile would give shards unequal logical dims
            if comp.grid[axis] % n_shards or comp.shape[axis] % n_shards \
                    or comp.shape[axis] % TILE:
                axis = None
        parity_nb = self.table[name]["parity"].nbytes
        scale_nb = self.table[name]["scale"].nbytes
        pages = np.asarray(comp.pages, np.int64)
        if axis is None:
            return ShardPlan(
                axis=None, n_shards=n_shards, kn=(k, n), local_kn=(k, n),
                local_grid=(kt, nt),
                q_pages=tuple(pages for _ in range(n_shards)),
                parity_nbytes=parity_nb, scale_nbytes=scale_nb)
        parts, local_grid = shard_tiles((kt, nt), n_shards, axis)
        local_kn = ((k, n // n_shards) if axis == 1
                    else (k // n_shards, n))
        return ShardPlan(
            axis=axis, n_shards=n_shards, kn=(k, n), local_kn=local_kn,
            local_grid=local_grid,
            q_pages=tuple(pages[p] for p in parts),
            parity_nbytes=parity_nb // n_shards,
            scale_nbytes=(scale_nb // n_shards if axis == 1 else scale_nb))

    def shard_host_slices(self, name: str, plan: ShardPlan):
        """Per-shard (parity, scale) host arrays of one entry, each in its
        shard's LOCAL tile order (matching the q partition). One read per
        component: the pages are counted once, not once per shard."""
        e = self.table[name]
        parity = self._get_flat(e["parity"])              # (K//8, N) uint8
        scale = self._get_flat(e["scale"])                # (1, N) f32
        if plan.axis is None:
            return [(parity, scale)] * plan.n_shards
        S = plan.n_shards
        kt, nt = e["q"].grid
        out = []
        if plan.axis == 1:
            p3 = parity.reshape(parity.shape[0], nt, TILE)
            s3 = scale.reshape(scale.shape[0], nt, TILE)
            for s in range(S):
                out.append((
                    np.ascontiguousarray(
                        p3[:, s::S, :]).reshape(parity.shape[0], -1),
                    np.ascontiguousarray(
                        s3[:, s::S, :]).reshape(scale.shape[0], -1)))
        else:
            rows = TILE // 8                 # parity rows per k-tile
            p3 = parity.reshape(kt, rows, parity.shape[1])
            for s in range(S):
                out.append((
                    np.ascontiguousarray(p3[s::S]).reshape(-1, parity.shape[1]),
                    scale))                  # row-parallel: scales replicate
        return out

    # --- accounting ---------------------------------------------------------

    @property
    def image_bytes(self) -> int:
        return self.n_pages * self.page_bytes

    def nand_seconds(self) -> float:
        """Analytical NAND array time for all reads since reset_counters."""
        return nand.nand_read_seconds(self.plane_reads)

    def stats(self) -> dict[str, Any]:
        out = {"entries": len(self.table), "pages": self.n_pages,
               "planes": self.n_planes, "image_bytes": self.image_bytes,
               "payload_bytes": self.total_bytes,
               "pages_read": int(self.pages_read),
               "bytes_read": int(self.bytes_read),
               "nand_seconds": self.nand_seconds(),
               # fault-plane counters (zero while no injector is armed)
               "uecc_detected": int(self.uecc_detected),
               "read_retries": int(self.read_retries),
               "retry_corrected": int(self.retry_corrected),
               "ecc_corrected_pages": int(self.ecc_corrected_pages),
               "relocations": int(self.relocations),
               "degraded_pages": len(self._degraded),
               "dram_fallback_reads": int(self.dram_fallback_reads),
               "plane_uecc": self.plane_uecc.tolist(),
               "plane_retries": self.plane_retries.tolist(),
               "plane_relocations": self.plane_relocations.tolist()}
        if self.injector is not None:
            out.update(self.injector.stats())
        return out

    def obs_samples(self):
        """ObsPlane scrape samples: the counters ``stats()`` reports, as
        Prometheus families, per-plane reads and damage labeled by plane.
        Lock-free reads: a scrape never waits behind a read."""
        yield Sample("nand_pages_read_total", "counter",
                     float(self.pages_read))
        yield Sample("nand_bytes_read_total", "counter",
                     float(self.bytes_read))
        yield Sample("nand_read_seconds_total", "counter",
                     float(self.nand_seconds()))
        yield Sample("nand_uecc_detected_total", "counter",
                     float(self.uecc_detected))
        yield Sample("nand_read_retries_total", "counter",
                     float(self.read_retries))
        yield Sample("nand_retry_corrected_total", "counter",
                     float(self.retry_corrected))
        yield Sample("nand_relocations_total", "counter",
                     float(self.relocations))
        yield Sample("nand_degraded_pages", "gauge",
                     float(len(self._degraded)))
        yield Sample("nand_dram_fallback_reads_total", "counter",
                     float(self.dram_fallback_reads))
        for plane in range(self.n_planes):
            lbl = (("plane", str(plane)),)
            yield Sample("nand_plane_reads_total", "counter",
                         float(self.plane_reads[plane]), lbl)
            if self.plane_uecc[plane]:
                yield Sample("nand_plane_uecc_total", "counter",
                             float(self.plane_uecc[plane]), lbl)
        if self.injector is not None:
            yield from self.injector.obs_samples()

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
