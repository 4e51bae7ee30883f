"""Overlapped layer streaming + residency cache for the FlashStore tier —
the port of ``repro/store/streamer.py`` (dense groups).

The streamed serving engine runs its layers group by group;
``LayerStreamer`` keeps the device window for group *l+1* filling WHILE
group *l*'s (asynchronously launched) compute runs: a worker thread reads
the group's pages out of the host ``PageStore``, uploads them into the
device page pool, and hands the window over a queue, at most
``prefetch_depth`` windows ahead. Time the consumer spends blocked on that
queue is the STALL time; time the worker spends reading + uploading is the
STREAM time.

``ResidencyCache`` is a byte-budgeted map of store keys to device-resident
windows with LRU eviction, where PINNED or ref-held entries are never
evicted. The engine pins the hot entries — lm_head (read every step) and
the first/last layer groups — and streams the rest; ``pin_all=True`` makes
everything resident.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import random
import threading
import time
from typing import Any, Callable, Iterator

from repro_torch.obs.registry import Sample
from repro_torch.obs.trace import TID_STREAM, default_tracer
from repro_torch.store.faults import StoreFault


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """How the engine runs the flash tier when given a ``weight_store``."""
    device_budget_bytes: int | None = None  # window + cache; None = unbounded
    group_size: int = 1                     # layers per streamed group
    prefetch_depth: int = 2                 # device windows in flight
    pin_all: bool = False                   # residency = everything
    pin_edges: bool = True                  # pin first/last groups if room
    # overlap-depth auto-tuning: after ``auto_depth_after`` measured steps,
    # re-pick prefetch_depth from the streamer's stall/stream telemetry
    auto_depth: bool = False
    auto_depth_after: int = 4
    # MoE expert paging: rows in the per-layer device expert slab (the
    # rotating window of the expert-paged plane; budget-accounted like the
    # dense windows). None = min(n_experts, worst-case routed set:
    # n_slots * chunk_tokens * top_k).
    expert_slab: int | None = None
    # experts the predictor prefetches for layer l+1 beyond the breadth of
    # the set the router just asked for (headroom for routing churn)
    prefetch_experts_margin: int = 1
    # the first ``pin_shared_experts`` experts of every MoE layer are pinned
    # device-resident at init (always-routed shared experts never pay an
    # upload); they count against the expert cache budget
    pin_shared_experts: int = 0
    # after ``auto_depth_after`` measured steps, if misroute stalls were
    # seen, return the slab's unused rows (e_slab vs the largest routed set
    # seen) to the expert cache's capacity; the slab itself is fixed
    auto_expert_budget: bool = False
    # tensor-parallel streamed serving: shard the page pool and the FFN
    # over ``n_shards`` devices on the "model" mesh (the engine's ``mesh``).
    # 1 = the single-device plane, unchanged. ``device_budget_bytes`` stays
    # the AGGREGATE budget: each device holds about budget / n_shards.
    n_shards: int = 1


@dataclasses.dataclass
class _Entry:
    value: Any
    nbytes: int
    refs: int = 0
    pinned: bool = False


class ResidencyCache:
    """Byte-budgeted LRU of device-resident weight groups.

    Invariants: pinned entries and entries with refs > 0 are never
    evicted; bytes_used == sum of resident entries' nbytes <= capacity
    (when bounded); hits + misses == number of acquire() calls.
    """

    def __init__(self, capacity_bytes: int | None = None,
                 on_evict: Callable[[Any, Any], None] | None = None):
        self.capacity = capacity_bytes
        # eviction hook (key, value): the engine frees an evicted window's
        # pool slots here. Runs under the cache lock; the hook may take the
        # pool lock (lock order is always cache -> pool).
        self._on_evict = on_evict
        self._entries: "collections.OrderedDict[Any, _Entry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0              # inserts that could not fit

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    @property
    def pinned_bytes(self) -> int:
        """Bytes held by pinned entries — the floor any re-budgeting must
        leave for the cache."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.pinned)

    def resize(self, capacity_bytes: int | None):
        """Re-budget the cache, at once LRU-evicting unpinned ref-free
        entries down to the new capacity."""
        with self._lock:
            self.capacity = capacity_bytes
            if capacity_bytes is None:
                return
            used = sum(e.nbytes for e in self._entries.values())
            for k in list(self._entries):
                if used <= capacity_bytes:
                    break
                e = self._entries[k]
                if e.pinned or e.refs > 0:
                    continue
                used -= e.nbytes
                del self._entries[k]
                self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(k, e.value)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def acquire(self, key):
        """Return the resident value (refs += 1, LRU-touch) or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            e.refs += 1
            self._entries.move_to_end(key)
            return e.value

    def release(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.refs > 0:
                e.refs -= 1

    def _eviction_candidates(self, key, pin: bool) -> list:
        """Victim order for an insert that needs room: LRU-first among
        unpinned ref-free entries. Called under the lock; a subclass
        overrides only this policy (the expert cache's score-aware
        admission), the insert mechanics stay shared."""
        return [k for k, e in self._entries.items()
                if not e.pinned and e.refs == 0]

    def insert(self, key, value, nbytes: int, pin: bool = False,
               hold: bool = False) -> bool:
        """Admit an entry, evicting ``_eviction_candidates`` (in order) to
        make room. Returns False (the entry stays non-resident, and the caller
        must discard ``value`` itself) if it cannot fit. ``hold=True``
        admits it with one ref already taken, for the consumer to
        ``release``."""
        with self._lock:
            if key in self._entries:
                e = self._entries[key]
                e.pinned = e.pinned or pin
                if hold:
                    e.refs += 1
                self._entries.move_to_end(key)
                return True
            used = sum(e.nbytes for e in self._entries.values())
            if self.capacity is not None:
                if nbytes > self.capacity:
                    self.rejects += 1
                    return False
                if used + nbytes > self.capacity:
                    for k in self._eviction_candidates(key, pin):
                        if used + nbytes <= self.capacity:
                            break
                        ev = self._entries.pop(k)
                        used -= ev.nbytes
                        self.evictions += 1
                        if self._on_evict is not None:
                            self._on_evict(k, ev.value)
                if used + nbytes > self.capacity:
                    self.rejects += 1
                    return False
            self._entries[key] = _Entry(value, int(nbytes), pinned=pin,
                                        refs=1 if hold else 0)
            return True

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "pinned": sum(e.pinned for e in self._entries.values()),
                    "bytes_used": sum(e.nbytes
                                      for e in self._entries.values()),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "rejects": self.rejects}

    def obs_samples(self, prefix: str = "stream_cache"):
        """ObsPlane scrape samples (lock-free counter reads)."""
        yield Sample(f"{prefix}_entries", "gauge", float(len(self._entries)))
        yield Sample(f"{prefix}_hits_total", "counter", float(self.hits))
        yield Sample(f"{prefix}_misses_total", "counter", float(self.misses))
        yield Sample(f"{prefix}_evictions_total", "counter",
                     float(self.evictions))
        yield Sample(f"{prefix}_rejects_total", "counter",
                     float(self.rejects))


class LayerStreamer:
    """Double-buffered streaming of layer-group windows from a PageStore.

    ``fetch(group) -> (device_window, nbytes)`` is supplied by the engine
    (it knows the window layout); the streamer owns overlap, residency,
    and the stall/stream accounting.
    """

    def __init__(self, n_groups: int,
                 fetch: Callable[[int], tuple[Any, int]],
                 cache: ResidencyCache,
                 prefetch_depth: int = 2,
                 discard: Callable[[Any], None] | None = None,
                 max_fetch_retries: int = 3,
                 retry_backoff_s: float = 0.01):
        self.n_groups = int(n_groups)
        self._fetch = fetch
        self.cache = cache
        # cleanup of a fetched window the cache did NOT keep, called after
        # the consumer retired it (the engine frees its pool slots)
        self._discard = discard
        self.prefetch_depth = max(1, int(prefetch_depth))
        # a transient fetch failure retries with jittered exponential
        # backoff; exhaustion escalates a typed StoreFault to the consumer
        self.max_fetch_retries = int(max_fetch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.fetch_retries = 0        # transient fetch failures retried
        self.fetch_faults = 0         # escalated StoreFaults
        self.stall_s = 0.0            # consumer blocked on the window queue
        self.stream_s = 0.0           # worker reading pages + uploading
        self.bytes_streamed = 0
        self.groups_streamed = 0

    def pin(self, g: int) -> bool:
        """Force-fetch a group's window and pin it device-resident."""
        window, nbytes = self._fetch(g)
        ok = self.cache.insert(g, window, nbytes, pin=True)
        if not ok and self._discard is not None:
            self._discard(window)
        return ok

    def _window(self, g: int):
        """Return (window, was_hit, cache_kept). A ref is held in both live
        cases (acquire on a hit, hold-insert on a kept miss), so the entry
        and its pool slots stay in place until the consumer retires it.
        kept=False: the cache rejected the window; the consumer discards
        it after retiring it."""
        win = self.cache.acquire(g)
        if win is not None:
            return win, True, True
        t0 = time.perf_counter()
        win, nbytes = self._fetch(g)
        dt = time.perf_counter() - t0
        # the trace's stream track: one span per fetched window, so the
        # compute-vs-stream overlap is visible per group
        default_tracer().complete(f"stream.group{g}", t0, dt,
                                  tid=TID_STREAM, cat="stream",
                                  args={"group": g, "bytes": int(nbytes)})
        self.stream_s += dt
        self.bytes_streamed += nbytes
        self.groups_streamed += 1
        kept = self.cache.insert(g, win, nbytes, hold=True)
        return win, False, kept

    def stream(self) -> Iterator[tuple[int, Any]]:
        """Yield (group, device_window) for groups 0..n-1 in order, with a
        worker thread prefetching ahead of the consumer.

        The slot semaphore bounds fetched-but-unretired windows (the one
        the consumer holds included) at ``prefetch_depth``: the worker
        starts on group l+d's pages only once the consumer has retired
        group l."""
        q: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        slots = threading.Semaphore(self.prefetch_depth)

        def fetch_with_retry(g):
            delay = self.retry_backoff_s
            attempts = self.max_fetch_retries + 1
            for attempt in range(attempts):
                if stop.is_set():
                    return None
                try:
                    return self._window(g)
                except Exception as e:
                    if attempt == attempts - 1:
                        self.fetch_faults += 1
                        fault = StoreFault(
                            f"group {g} window fetch failed after "
                            f"{attempts} attempts: {e!r}")
                        fault.__cause__ = e
                        return fault
                    self.fetch_retries += 1
                    time.sleep(delay * (1.0 + random.random()))
                    delay *= 2.0

        def worker():
            for g in range(self.n_groups):
                while not slots.acquire(timeout=0.05):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                try:
                    item = fetch_with_retry(g)
                except BaseException as e:    # non-Exception (interrupt):
                    q.put((g, e))             # surface in the consumer
                    return
                if item is None:              # stopped mid-retry
                    return
                q.put((g, item))
                if isinstance(item, BaseException):
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        held: tuple | None = None             # yielded but not yet retired

        def _retire(g, win, kept):
            # a kept window carries one liveness ref; a rejected transient
            # is ours to discard — in both cases only after the consumer
            # launched its compute against it.
            if kept:
                self.cache.release(g)
            elif self._discard is not None:
                self._discard(win)

        try:
            for _ in range(self.n_groups):
                t0 = time.perf_counter()
                g, item = q.get()
                self.stall_s += time.perf_counter() - t0
                if isinstance(item, BaseException):
                    raise item                # worker-side fetch failure
                win, hit, kept = item
                held = (g, win, kept)
                yield g, win
                _retire(g, win, kept)
                held = None
                slots.release()
        finally:
            stop.set()
            # an abandoned iteration must not leak cache refs or transient
            # pool slots: retire the held window and everything queued —
            # after the worker has ended, so that a fetch in flight at the
            # stop is drained too.
            if held is not None:
                _retire(*held)
            t.join()
            while True:
                try:
                    g, item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, tuple):
                    _retire(g, item[0], item[2])

    def stats(self) -> dict:
        return {"stall_s": self.stall_s, "stream_s": self.stream_s,
                "bytes_streamed": self.bytes_streamed,
                "groups_streamed": self.groups_streamed,
                "fetch_retries": self.fetch_retries,
                "fetch_faults": self.fetch_faults,
                **{f"cache_{k}": v for k, v in self.cache.stats().items()}}

    def obs_samples(self):
        """ObsPlane scrape samples (lock-free): the overlap accounting —
        stall vs stream seconds — plus fetch traffic and fault counters."""
        yield Sample("stream_stall_seconds_total", "counter",
                     float(self.stall_s))
        yield Sample("stream_seconds_total", "counter",
                     float(self.stream_s))
        yield Sample("stream_bytes_total", "counter",
                     float(self.bytes_streamed))
        yield Sample("stream_groups_total", "counter",
                     float(self.groups_streamed))
        yield Sample("stream_fetch_retries_total", "counter",
                     float(self.fetch_retries))
        yield Sample("stream_fetch_faults_total", "counter",
                     float(self.fetch_faults))
        yield Sample("stream_prefetch_depth", "gauge",
                     float(self.prefetch_depth))
        yield from self.cache.obs_samples()
