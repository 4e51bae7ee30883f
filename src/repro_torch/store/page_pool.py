"""Device-resident weight page pool: NAND pages to compute, no host slabs —
the port of ``repro/store/page_pool.py`` (``WeightPagePool`` and, for
tensor-parallel streamed serving, ``ShardedWeightPagePool``).

  * ONE device tensor ``(n_pages, 16 KiB) int8`` holds raw store pages —
    the bytes the PageStore serialized, untouched (q tiles, parity runs,
    scale runs).
  * ``upload(names)`` moves a whole window in ONE staged transfer: one
    contiguous ``read_pages`` into a reusable pinned host staging buffer,
    one asynchronous host-to-device copy on the pool's own copy stream,
    one ``index_copy_`` into free pool slots — and returns the per-name
    PAGE TABLES that ``core.tiering.PagedWeight`` / ``kernels/paged_ecdp``
    consume in place.
  * the allocator is host-side: a free-slot list with O(1) release and
    double-free guards. Entry lifecycle (ref counts, pins, eviction) stays
    in the ``ResidencyCache``, which frees an entry's slots through its
    eviction hook.

Ordering on the card. JAX orders a donated in-place scatter after every
in-flight reader; CUDA streams order nothing across streams, so the pool
does it with events. Every kernel that reads the pool runs on one
consumer stream (``stream``, the engine's); uploads run on the pool's copy
stream, from any thread.
  * read after write: ``upload`` records an event after its copies; each
    returned table carries it as ``"ready"``, and the consumer's stream
    waits on it before reading the window.
  * write after read: ``free`` records an event on the consumer stream;
    the copy stream waits on the events of the slots an upload pops before
    it writes them, so a launch that read a slot before it was freed still
    reads the old page.
  * the pinned staging rows are refilled only after the previous copy out
    of them has finished (a host wait on its event).
  * what the copy stream writes is allocated on the copy stream (the
    caching allocator may hand out a block the consumer freed while its
    queued kernels still read it) and marked used by the consumer.
  * ``_grow`` (a rare path; a pool sized at init never takes it) runs
    between two device synchronizations.
On the CPU every operation is synchronous and none of this is needed.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.obs.registry import Sample
from repro_torch.obs.trace import TID_POOL, default_tracer


class WeightPagePool:
    """Device page pool + host slot allocator over a ``PageStore``."""

    def __init__(self, store: Any, n_pages: int, device="cuda",
                 stream: "torch.cuda.Stream | None" = None):
        self.store = store
        self.device = torch.device(device)
        self.page_bytes = int(store.page_bytes)
        self.n_pages = max(int(n_pages), 1)
        self._cuda = self.device.type == "cuda"
        self.stream = None
        self._copy_stream = None
        if self._cuda:
            self.stream = stream or torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        with self._on_consumer():
            self.data = torch.zeros((self.n_pages, self.page_bytes),
                                    dtype=torch.int8, device=self.device)
        self._free: list[int] = list(range(self.n_pages))[::-1]
        self._allocated: set[int] = set()
        self._freed_at: dict[int, torch.cuda.Event] = {}
        self._lock = threading.Lock()
        self.grows = 0
        self._staging: torch.Tensor | None = None
        self._staging_done: list = []     # the last copies out of it
        self.staging_allocs = 0
        self._h2d: list[tuple] = []          # (start, end) not yet summed
        self.reset_counters()

    def _on_consumer(self):
        """Allocate on the consumer's stream, so that a freed tensor's
        memory is reused only after the consumer's reads of it."""
        if not self._cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def reset_counters(self):
        """Zero the transfer counters (init-time pin uploads are deployment,
        not serving)."""
        with self._lock:
            self._fold_h2d(wait=True)
            self.uploads = 0
            self.pages_staged = 0
            self.bytes_staged = 0
            self.pinned_uploads = 0
            self.h2d_s = 0.0

    def _fold_h2d(self, wait: bool):
        """Add the finished host-to-device copies' times to ``h2d_s``."""
        keep = []
        for start, end in self._h2d:
            if wait:
                end.synchronize()
            if end.query():
                self.h2d_s += start.elapsed_time(end) / 1e3
            else:
                keep.append((start, end))
        self._h2d = keep

    def _stage_host(self, n_rows: int) -> torch.Tensor:
        """First ``n_rows`` page rows of the reusable staging buffer (pinned
        on the card), once the last copy out of it has finished."""
        for done in self._staging_done:
            done.synchronize()
        if self._staging is None or self._staging.shape[0] < n_rows:
            cap = max(n_rows, 2 * (0 if self._staging is None
                                   else self._staging.shape[0]))
            self._staging = torch.empty((cap, self.page_bytes),
                                        dtype=torch.uint8,
                                        pin_memory=self._cuda)
            self.staging_allocs += 1
        return self._staging[:n_rows]

    # --- allocator ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._allocated)

    def _grow(self, need: int):
        """Reallocate the pool (under the lock) between two device
        synchronizations: no copy or read of the old tensor is in flight
        when it is copied, and the old tensor is never written again, so
        a launch still bound to it reads what it held."""
        cap = max(2 * self.n_pages, self.n_pages + need)
        if self._cuda:
            torch.cuda.synchronize(self.device)
        with self._on_consumer():
            grown = torch.zeros((cap, self.page_bytes), dtype=torch.int8,
                                device=self.device)
            grown[:self.n_pages] = self.data
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self.data = grown
        self._free.extend(range(self.n_pages, cap))
        self.n_pages = cap
        self.grows += 1

    def free(self, slots: Iterable[int]):
        """O(1)-per-slot release. On the card an event on the consumer
        stream marks the slots' last readers; the next upload into them
        waits for it."""
        with self._lock:
            freed = self._record_consumers()
            for s in slots:
                s = int(s)
                if s not in self._allocated:
                    raise ValueError(f"free of unallocated pool slot {s}")
                self._allocated.remove(s)
                self._free.append(s)
                if freed is not None:
                    self._freed_at[s] = freed

    def _record_consumers(self):
        """An event on the consumer stream (None on the CPU): where the
        consumer's launches so far end."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait_ready(self, ready):
        """Make the consumer stream wait for an upload's ``"ready"``
        event (a no-op on the CPU)."""
        if ready is not None:
            self.stream.wait_event(ready)

    # --- the one staged transfer --------------------------------------------

    def upload(self, names: Iterable[str]) -> dict[str, dict]:
        """Upload every page of ``names`` (store entry names) in ONE staged
        transfer and return per-name page tables:

          {name: {"q_tbl" (kt, nt) i32, "p_slots" (np,) i32,
                  "s_slots" (ns,) i32, "kn" (K, N), "slots" (all,) i32,
                  "dev": (q_tbl, p_slots, s_slots) int32 tensors on the
                  pool's device, "ready": the event the consumer waits on
                  (None on the CPU)}}

        ``slots`` is the hand-back token for ``free``. Runs on the streamer
        worker or the engine's thread; the lock serializes uploads, frees
        and grows."""
        names = list(names)
        plan: list[tuple[str, str, list[int]]] = []   # (name, comp, page_ids)
        for name in names:
            entry = self.store.table[name]
            for comp in ("q", "parity", "scale"):
                plan.append((name, comp, entry[comp].pages))
        ids = np.concatenate([np.asarray(p, np.int64) for _, _, p in plan])
        tracer = default_tracer()
        t0 = time.perf_counter() if tracer.enabled else 0.0
        with self._lock:
            if len(ids) > len(self._free):
                self._grow(len(ids) - len(self._free))
            slots = np.array([self._free.pop() for _ in range(len(ids))],
                             np.int32)
            self._allocated.update(int(s) for s in slots)
            # a faulted read must hand the window's slots back before
            # propagating: a retried upload re-allocates
            try:
                slots_dev, ready = self._transfer(ids, slots)
            except Exception:
                self._allocated.difference_update(int(s) for s in slots)
                self._free.extend(int(s) for s in slots)
                raise
            self.uploads += 1
            self.pages_staged += int(ids.size)
            self.bytes_staged += int(ids.size) * self.page_bytes
        tracer.complete("pool.upload", t0, time.perf_counter() - t0,
                        tid=TID_POOL, cat="pool",
                        args={"pages": int(ids.size),
                              "bytes": int(ids.size) * self.page_bytes})
        out: dict[str, dict] = {}
        off = 0
        for name, comp, pages in plan:
            n = len(pages)
            span, span_dev = slots[off:off + n], slots_dev[off:off + n]
            off += n
            tbl = out.setdefault(name, {"dev": [], "ready": ready})
            if comp == "q":
                grid = self.store.table[name]["q"].grid
                tbl["q_tbl"] = span.reshape(grid).copy()
                tbl["kn"] = tuple(self.store.table[name]["q"].shape)
                tbl["dev"].append(span_dev.view(grid))
            elif comp == "parity":
                tbl["p_slots"] = span.copy()
                tbl["dev"].append(span_dev)
            else:
                tbl["s_slots"] = span.copy()
                tbl["dev"].append(span_dev)
        for tbl in out.values():
            tbl["dev"] = tuple(tbl["dev"])
            tbl["slots"] = np.concatenate(
                [tbl["q_tbl"].reshape(-1), tbl["p_slots"], tbl["s_slots"]])
        return out

    def _transfer(self, ids: np.ndarray, slots: np.ndarray):
        """Store pages ``ids`` -> pool rows ``slots``: one read into the
        staging rows, one host-to-device copy, one ``index_copy_``.
        Returns (slots as an int32 tensor on the device — the page tables
        are views of it —, the ready event or None)."""
        rows = self._stage_host(len(ids))
        self.store.read_pages(ids, out=rows.numpy())
        if not self._cuda:
            self.data.index_copy_(0, torch.from_numpy(slots).long(),
                                  rows.view(torch.int8))
            return torch.from_numpy(slots.copy()), None
        cs = self._copy_stream
        with torch.cuda.device(self.device), torch.cuda.stream(cs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(cs)
            pages = rows.to(self.device, non_blocking=True).view(torch.int8)
            end.record(cs)
            self._staging_done = [end]
            self._h2d.append((start, end))
            self.pinned_uploads += 1
            # allocated on this stream (a block the consumer freed may still
            # be read by its queued kernels), reused only after the
            # consumer's reads of it
            slots_dev = torch.from_numpy(slots).pin_memory().to(
                self.device, non_blocking=True)
            slots_dev.record_stream(self.stream)
            for ev in {id(e): e for e in (self._freed_at.pop(int(s), None)
                                           for s in slots)
                       if e is not None}.values():
                cs.wait_event(ev)         # the slots' last readers are done
            self.data.index_copy_(0, slots_dev.long(), pages)
            ready = torch.cuda.Event()
            ready.record(cs)
            self._fold_h2d(wait=False)
        return slots_dev, ready

    # --- device-facing view -------------------------------------------------

    @property
    def buffer(self) -> torch.Tensor:
        """The current pool tensor. Bind it when launching: after a
        ``_grow`` it is a new tensor holding every live slot."""
        return self.data

    def stats(self) -> dict:
        with self._lock:
            self._fold_h2d(wait=True)
            return {"pool_pages": self.n_pages,
                    "pool_free_pages": len(self._free),
                    "pool_used_pages": len(self._allocated),
                    "pool_uploads": self.uploads,
                    "pool_pages_staged": self.pages_staged,
                    "pool_bytes_staged": self.bytes_staged,
                    "pool_pinned_uploads": self.pinned_uploads,
                    "pool_staging_allocs": self.staging_allocs,
                    "pool_h2d_s": self.h2d_s,
                    "pool_grows": self.grows}

    def obs_samples(self):
        """ObsPlane scrape samples. Lock-free: ``upload`` holds the pool
        lock across a whole staged transfer, and a scrape must not wait
        behind it."""
        yield Sample("pool_pages", "gauge", float(self.n_pages))
        yield Sample("pool_free_pages", "gauge", float(len(self._free)))
        yield Sample("pool_uploads_total", "counter", float(self.uploads))
        yield Sample("pool_pages_staged_total", "counter",
                     float(self.pages_staged))
        yield Sample("pool_bytes_staged_total", "counter",
                     float(self.bytes_staged))
        yield Sample("pool_pinned_uploads_total", "counter",
                     float(self.pinned_uploads))
        yield Sample("pool_grows_total", "counter", float(self.grows))


class ShardedWeightPagePool(WeightPagePool):
    """The tensor-parallel pool: ONE logical pool whose pages are sharded
    over the mesh's "model" axis, ``n_pages`` LOCAL slots per shard, shard
    ``s``'s partition a tensor on ``mesh.devices[s]``.

    Slots are SYMMETRIC: every shard uses the same local slot ids for the
    same entry (``PageStore.shard_entry`` gives each shard the same page
    counts), so ONE host free list allocates for all shards at once and
    ``upload`` returns page tables in the unsharded format — ``q_tbl`` over
    the shard-LOCAL grid with the shard-LOCAL ``kn`` — that the paged ECDP
    consumes unchanged on each shard's partition. Each table also carries
    ``"dev_shards"``, its device tables per shard (``"dev"`` is shard 0's),
    and ``"ready"`` holds one event per distinct device.

    ``upload`` moves a window as ONE staged transfer PER SHARD: one host
    staging assembly ``(n_shards, n_slots, page_bytes)``, then per shard
    one host-to-device copy and one ``index_copy_`` into its partition
    (on one copy stream per distinct device). ``shard_transfers`` counts
    the copies: ``n_shards`` a rotation.

    Which entries split, and along which axis, is ``axis_of`` (default
    ``launch.sharding.tp_shard_axis``): w_gate / w_up by tile columns,
    w_down by tile rows, the attention copies and the rest replicated.
    Parity and scale runs follow their tiles (``shard_host_slices``)."""

    def __init__(self, store: Any, n_pages: int, mesh,
                 axis_of: Callable[[str], int | None] | None = None,
                 stream: "torch.cuda.Stream | None" = None):
        self.store = store
        self.mesh = mesh
        self.n_shards = int(mesh.n_shards)
        self.devices = tuple(torch.device(d) for d in mesh.devices)
        self.device = self.devices[0]
        self.page_bytes = int(store.page_bytes)
        self.n_pages = max(int(n_pages), 1)        # LOCAL slots per shard
        if axis_of is None:
            from repro_torch.launch.sharding import tp_shard_axis
            axis_of = tp_shard_axis
        self._axis_of = axis_of
        self._plans: dict[str, Any] = {}           # ShardPlan memo per entry
        self._cuda = self.device.type == "cuda"
        # distinct devices, in shard order; shard s runs on _devs[_di[s]]
        self._devs = list(dict.fromkeys(self.devices))
        self._di = [self._devs.index(d) for d in self.devices]
        self.stream = None
        self.streams: list = []
        self._copy_streams: list = []
        if self._cuda:
            self.stream = stream or torch.cuda.current_stream(self.device)
            self.streams = [self.stream] + [torch.cuda.current_stream(d)
                                            for d in self._devs[1:]]
            self._copy_streams = [torch.cuda.Stream(d) for d in self._devs]
        self.parts = self._alloc_parts(self.n_pages)
        self._free: list[int] = list(range(self.n_pages))[::-1]
        self._allocated: set[int] = set()
        self._freed_at: dict[int, tuple] = {}
        self._lock = threading.Lock()
        self.grows = 0
        self._staging: torch.Tensor | None = None
        self._staging_done: list = []
        self.staging_allocs = 0
        self._h2d: list[tuple] = []
        self.reset_counters()

    def _alloc_parts(self, n_pages: int) -> list:
        """One zeroed (n_pages, page_bytes) partition per shard, each on
        its device, allocated on its consumer stream."""
        parts = []
        for s, dev in enumerate(self.devices):
            ctx = (torch.cuda.stream(self.streams[self._di[s]])
                   if self._cuda else contextlib.nullcontext())
            with ctx:
                parts.append(torch.zeros((n_pages, self.page_bytes),
                                         dtype=torch.int8, device=dev))
        return parts

    def reset_counters(self):
        super().reset_counters()
        with self._lock:
            self.shard_transfers = 0

    def _record_consumers(self):
        if not self._cuda:
            return None
        evs = []
        for st in self.streams:
            ev = torch.cuda.Event()
            ev.record(st)
            evs.append(ev)
        return tuple(evs)

    def wait_ready(self, ready):
        """Make each device's consumer stream wait for its copies of an
        upload (a no-op on the CPU)."""
        if ready is not None:
            for st, ev in zip(self.streams, ready):
                st.wait_event(ev)

    def _grow(self, need: int):
        """Grow every shard's partition in lockstep (slot symmetry must
        survive), between two synchronizations of every device."""
        cap = max(2 * self.n_pages, self.n_pages + need)
        if self._cuda:
            for d in self._devs:
                torch.cuda.synchronize(d)
        grown = self._alloc_parts(cap)
        for new, old in zip(grown, self.parts):
            new[:self.n_pages] = old
        if self._cuda:
            for d in self._devs:
                torch.cuda.synchronize(d)
        self.parts = grown
        self._free.extend(range(self.n_pages, cap))
        self.n_pages = cap
        self.grows += 1

    def plan(self, name: str):
        """The (memoized) ShardPlan of one entry: the page table is
        write-once, so its partition never changes."""
        p = self._plans.get(name)
        if p is None:
            p = self._plans[name] = self.store.shard_entry(
                name, self.n_shards, self._axis_of(name))
        return p

    def upload(self, names: Iterable[str]) -> dict[str, dict]:
        """The sharded window rotation: the base ``upload``'s contract, with
        shard-LOCAL tables (local ``q_tbl`` grid, local ``kn``) and one
        staged copy per shard."""
        names = list(names)
        S = self.n_shards
        rows_plan: list[tuple[str, str, int]] = []  # (name, comp, n_pages)
        for name in names:
            p = self.plan(name)
            rows_plan += [
                (name, "q", len(p.q_pages[0])),
                (name, "parity", -(-p.parity_nbytes // self.page_bytes)),
                (name, "scale", -(-p.scale_nbytes // self.page_bytes))]
        n_slots = sum(n for _, _, n in rows_plan)
        tracer = default_tracer()
        t0 = time.perf_counter() if tracer.enabled else 0.0
        with self._lock:
            if n_slots > len(self._free):
                self._grow(n_slots - len(self._free))
            slots = np.array([self._free.pop() for _ in range(n_slots)],
                             np.int32)
            self._allocated.update(int(s) for s in slots)
            # a faulted staged read returns the rotation's slots before
            # propagating, as the base upload does
            try:
                rows = self._stage_host(S * n_slots).view(S, n_slots,
                                                          self.page_bytes)
                self._stage_shards(names, rows_plan, rows.numpy())
                slots_dev, ready = self._transfer_shards(rows, slots)
            except Exception:
                self._allocated.difference_update(int(s) for s in slots)
                self._free.extend(int(s) for s in slots)
                raise
            self.uploads += 1
            self.shard_transfers += S
            self.pages_staged += n_slots * S
            self.bytes_staged += n_slots * S * self.page_bytes
        tracer.complete("pool.upload_sharded", t0,
                        time.perf_counter() - t0, tid=TID_POOL, cat="pool",
                        args={"shards": S, "pages": n_slots * S,
                              "bytes": n_slots * S * self.page_bytes})
        out: dict[str, dict] = {}
        off = 0
        for name, comp, n in rows_plan:
            span = slots[off:off + n]
            spans = [t[off:off + n] for t in slots_dev]
            off += n
            p = self.plan(name)
            tbl = out.setdefault(name, {"dev_shards": [[] for _ in range(S)],
                                        "ready": ready})
            if comp == "q":
                tbl["q_tbl"] = span.reshape(p.local_grid).copy()
                tbl["kn"] = tuple(p.local_kn)
                spans = [t.view(p.local_grid) for t in spans]
            elif comp == "parity":
                tbl["p_slots"] = span.copy()
            else:
                tbl["s_slots"] = span.copy()
            for s in range(S):
                tbl["dev_shards"][s].append(spans[self._di[s]])
        for tbl in out.values():
            tbl["dev_shards"] = tuple(tuple(d) for d in tbl["dev_shards"])
            tbl["dev"] = tbl["dev_shards"][0]
            tbl["slots"] = np.concatenate(
                [tbl["q_tbl"].reshape(-1), tbl["p_slots"], tbl["s_slots"]])
        return out

    def _stage_shards(self, names: list[str], rows_plan,
                      host: np.ndarray) -> None:
        """Assemble one rotation's (n_shards, n_slots, page_bytes) host
        staging: q pages read per shard (distinct global pages, each read
        once), parity / scale cut on the host by ``shard_host_slices``
        (their pages read once, not once per shard), replicated entries
        read once and copied into every shard's rows."""
        S = self.n_shards
        slices = {n: self.store.shard_host_slices(n, self.plan(n))
                  for n in names}
        off = 0
        for name, comp, n in rows_plan:
            p = self.plan(name)
            if comp == "q":
                if p.axis is None:
                    host[:, off:off + n] = self.store.read_pages(
                        p.q_pages[0])[None]
                else:
                    for s in range(S):
                        self.store.read_pages(p.q_pages[s],
                                              out=host[s, off:off + n])
            else:
                idx = 0 if comp == "parity" else 1
                for s in range(S):
                    flat = np.frombuffer(slices[name][s][idx].tobytes(),
                                         np.uint8)
                    run = host[s, off:off + n].reshape(-1)
                    run[:flat.size] = flat
                    run[flat.size:] = 0
            off += n

    def _transfer_shards(self, rows: torch.Tensor, slots: np.ndarray):
        """The staged rows -> each shard's partition at ``slots``: one
        host-to-device copy and one ``index_copy_`` per shard. Returns
        (the slots as an int32 tensor on each distinct device, the ready
        events per distinct device or None)."""
        if not self._cuda:
            idx = torch.from_numpy(slots).long()
            for s, part in enumerate(self.parts):
                part.index_copy_(0, idx, rows[s].view(torch.int8))
            return [torch.from_numpy(slots.copy())], None
        ends, slots_dev = [], []
        for i, dev in enumerate(self._devs):
            cs = self._copy_streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(cs):
                # allocated on the copy stream, reused only after the
                # consumer's reads of it (see WeightPagePool._transfer)
                sd = torch.from_numpy(slots).pin_memory().to(
                    dev, non_blocking=True)
                sd.record_stream(self.streams[i])
                slots_dev.append(sd)
                waits = {id(e): e for e in (self._freed_at.get(int(s))
                                            for s in slots)
                         if e is not None}
                for evs in waits.values():
                    cs.wait_event(evs[i])  # the slots' last readers are done
        for s in slots:
            self._freed_at.pop(int(s), None)
        ready = []
        for i, dev in enumerate(self._devs):
            cs = self._copy_streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(cs):
                idx = slots_dev[i].long()
                for s in range(self.n_shards):
                    if self._di[s] != i:
                        continue
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(cs)
                    pages = rows[s].to(dev, non_blocking=True).view(torch.int8)
                    end.record(cs)
                    ends.append(end)
                    self._h2d.append((start, end))
                    self.pinned_uploads += 1
                    self.parts[s].index_copy_(0, idx, pages)
                ev = torch.cuda.Event()
                ev.record(cs)
                ready.append(ev)
        self._staging_done = ends
        self._fold_h2d(wait=False)
        return slots_dev, tuple(ready)

    @property
    def buffer(self) -> tuple:
        """The shards' current partitions, in shard order."""
        return tuple(self.parts)

    def stats(self) -> dict:
        base = super().stats()
        with self._lock:
            base.update({
                "pool_shards": self.n_shards,
                "pool_shard_transfers": self.shard_transfers,
                "pool_local_pages": self.n_pages,
                "pool_local_bytes": self.n_pages * self.page_bytes})
        return base

    def obs_samples(self):
        yield from super().obs_samples()
        yield Sample("pool_shards", "gauge", float(self.n_shards))
        yield Sample("pool_shard_transfers_total", "counter",
                     float(self.shard_transfers))
