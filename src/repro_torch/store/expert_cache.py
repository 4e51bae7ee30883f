"""Routed-expert paging through the flash tier — the port of
``repro/store/expert_cache.py``.

MoE is NVLLM's best-fit case: about 97 % of a qwen3-moe / phi3.5-moe model
is expert banks of which only ``top_k / n_experts`` are touched per token,
so page-granular routed-expert fetch is exactly the access pattern the
paper's NAND-resident FFN rewards. The streamed MoE engine keeps the
expert banks in the ``PageStore`` and, each layer of each step, reads the
router's top-k expert ids on the host (the MoE analog of Algorithm 2's
plane bitmap); only THOSE experts' pages cross to the device.

``ExpertCache`` is the residency layer for that traffic: byte-budgeted and
ref-counted like ``ResidencyCache`` (pinned or ref-held entries are never
evicted; resident bytes never exceed capacity), but keyed by ``(layer,
expert)`` and extended with a ROUTER-HISTORY PREDICTOR, a per ``(layer,
expert)`` EMA of routed-expert hits. While layer *l*'s expert compute
runs, ``ExpertPrefetcher``'s worker thread fetches layer *l+1*'s
most-likely experts (EMA top-m) into the cache, so a correctly predicted
expert is already device-resident when its router asks for it. A routed
expert that is NOT resident is fetched synchronously on the compute path:
a MISROUTE STALL, counted and timed in ``stats()``. On the card the
worker's uploads go to the page pool's copy stream, as the dense
streamer's do, and each fetched value carries the upload's ``ready``
event for the consumer to wait on.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterable

import numpy as np

from repro_torch.obs.registry import Sample
from repro_torch.store.streamer import ResidencyCache


class ExpertCache(ResidencyCache):
    """Byte-budgeted, ref-counted residency for ``(layer, expert)`` weight
    sets, plus the router-history predictor driving prefetch.

    Invariants: all of ``ResidencyCache``'s — bytes_used <= capacity, pinned/ref-held entries
    survive every eviction, hit+miss == acquires — under concurrent
    insert/acquire/evict traffic from the prefetch worker.
    """

    def __init__(self, capacity_bytes: int | None, n_layers: int,
                 n_experts: int, ema_alpha: float = 0.3,
                 n_slots: int = 0, on_evict=None):
        super().__init__(capacity_bytes, on_evict=on_evict)
        self.n_layers = int(n_layers)
        self.n_experts = int(n_experts)
        self.ema_alpha = float(ema_alpha)
        # per-(layer, expert) EMA of router hits — the prefetch signal
        self.scores = np.zeros((self.n_layers, self.n_experts), np.float64)
        # per-SLOT histories (n_slots > 0): one EMA plane per decode slot.
        # A batch mixes sequences in different routing phases; the global
        # EMA blurs them into a mean that mispredicts every slot (observed:
        # hundreds of misroute stalls/run at phase boundaries). Slot planes
        # keep each sequence's phase sharp; ``predict`` max-combines the
        # ACTIVE slots' planes so any slot's hot expert makes the cut.
        self.n_slots = int(n_slots)
        self.slot_scores = np.zeros(
            (max(self.n_slots, 0), self.n_layers, self.n_experts),
            np.float64)
        self.reset_counters()

    def reset_counters(self):
        """Zero the traffic counters (init-time pin fetches are deployment,
        not serving — mirrors PageStore.reset_counters)."""
        with self._lock:
            self.bytes_fetched = 0
            self.fetches = 0
            self.prefetches = 0
            self.prefetched_bytes = 0
            self.misroute_stalls = 0
            self.misroute_stall_s = 0.0
            # per-slot routed-expert residency: requested / already-resident
            # counts per decode slot (expert_stats() reports the hit rate)
            self.slot_requests = np.zeros((max(self.n_slots, 0),), np.int64)
            self.slot_hits = np.zeros((max(self.n_slots, 0),), np.int64)

    # --- router-history predictor -------------------------------------------

    def observe(self, layer: int, experts: Iterable[int]):
        """Fold one step's routed-expert set for ``layer`` into the EMA."""
        hit = np.zeros((self.n_experts,), np.float64)
        ids = np.asarray(list(experts), np.int64)
        if ids.size:
            hit[ids] = 1.0
        a = self.ema_alpha
        self.scores[layer] = (1.0 - a) * self.scores[layer] + a * hit

    def observe_slot(self, slot: int, layer: int, experts: Iterable[int]):
        """Fold one slot's routed set into that slot's EMA plane (and keep
        the global plane updated through ``observe`` separately)."""
        if not (0 <= slot < self.n_slots):
            return
        hit = np.zeros((self.n_experts,), np.float64)
        ids = np.asarray(list(experts), np.int64)
        if ids.size:
            hit[ids] = 1.0
        a = self.ema_alpha
        self.slot_scores[slot, layer] = \
            (1.0 - a) * self.slot_scores[slot, layer] + a * hit

    def note_slot_route(self, slot: int, requested: int, missing: int):
        """Account one (slot, layer) routing event: ``requested`` experts
        asked for, ``missing`` of them not yet device-resident."""
        if not (0 <= slot < self.n_slots):
            return
        with self._lock:
            self.slot_requests[slot] += int(requested)
            self.slot_hits[slot] += int(requested) - int(missing)

    def slot_hit_rates(self) -> list[float]:
        with self._lock:
            return [float(h) / r if r else 0.0
                    for h, r in zip(self.slot_hits, self.slot_requests)]

    def predict(self, layer: int, m: int,
                slots: Iterable[int] | None = None) -> list[int]:
        """The up-to-``m`` most-likely experts for ``layer`` (EMA top-m,
        zero-score experts never predicted — no history, no prefetch).
        With ``slots`` (the ACTIVE decode slots) and per-slot tracking on,
        the signal is max(global, per-slot maxima): a slot whose phase
        diverges from the batch mean still gets its hot experts ranked."""
        s = self.scores[layer]
        if slots is not None and self.n_slots > 0:
            ids = [int(i) for i in slots if 0 <= int(i) < self.n_slots]
            if ids:
                s = np.maximum(s, self.slot_scores[ids, layer].max(axis=0))
        order = np.argsort(-s, kind="stable")[:max(int(m), 0)]
        return [int(e) for e in order if s[e] > 0.0]

    # --- score-aware admission ------------------------------------------------

    def _score(self, key) -> float:
        li, e = key
        if 0 <= li < self.n_layers and 0 <= e < self.n_experts:
            return float(self.scores[li, e])
        return 0.0

    def _eviction_candidates(self, key, pin: bool) -> list:
        """Score-aware admission (the only departure from the base LRU
        policy): an eviction victim must be strictly COLDER (lower
        predictor score) than the incoming expert, coldest first. A
        rotating working set larger than the cache turns plain LRU into a
        thrash loop — every miss evicts next step's hit — whereas under
        score parity nothing moves: stable routing freezes the resident
        set at maximal hits, and a routing SHIFT decays stale scores
        until the new hot set displaces them. Pinned inserts always
        outrank; pinned/ref-held entries are never victims (base-class
        guard)."""
        s_new = float("inf") if pin else self._score(key)
        return sorted((k for k, e in self._entries.items()
                       if not e.pinned and e.refs == 0
                       and self._score(k) < s_new),
                      key=self._score)

    def would_admit(self, key, nbytes: int) -> bool:
        """Cheap pre-check for the prefetcher: would a score-aware insert
        of ``key`` succeed right now? (Advisory — insert re-checks under
        the same lock — but it keeps speculative fetches from reading
        pages the cache would immediately reject.) Resident keys report
        False: nothing to prefetch."""
        s_new = self._score(key)
        with self._lock:
            if key in self._entries:
                return False
            if self.capacity is None:
                return True
            if nbytes > self.capacity:
                return False
            used = sum(e.nbytes for e in self._entries.values())
            if used + nbytes <= self.capacity:
                return True
            reclaimable = sum(
                e.nbytes for k, e in self._entries.items()
                if not e.pinned and e.refs == 0 and self._score(k) < s_new)
            return used - reclaimable + nbytes <= self.capacity

    # --- traffic accounting (thread-safe: main + prefetch worker) -------------

    def note_fetch(self, nbytes: int, prefetch: bool = False):
        with self._lock:
            self.fetches += 1
            self.bytes_fetched += int(nbytes)
            if prefetch:
                self.prefetches += 1
                self.prefetched_bytes += int(nbytes)

    def note_stall(self, seconds: float):
        with self._lock:
            self.misroute_stalls += 1
            self.misroute_stall_s += float(seconds)

    def stats(self) -> dict:
        base = super().stats()
        with self._lock:
            base.update({
                "bytes_fetched": self.bytes_fetched,
                "fetches": self.fetches,
                "prefetches": self.prefetches,
                "prefetched_bytes": self.prefetched_bytes,
                "misroute_stalls": self.misroute_stalls,
                "misroute_stall_s": self.misroute_stall_s,
            })
            if self.n_slots > 0:
                base["slot_hit_rates"] = [
                    float(h) / r if r else 0.0
                    for h, r in zip(self.slot_hits, self.slot_requests)]
        return base

    def obs_samples(self):
        """ObsPlane scrape samples (lock-free): routed-acquire hit rate,
        fetch traffic, and the misroute-stall attribution the streamed
        MoE engine's admission budget contracts with."""
        yield from super().obs_samples(prefix="expert_cache")
        yield Sample("expert_bytes_fetched_total", "counter",
                     float(self.bytes_fetched))
        yield Sample("expert_fetches_total", "counter", float(self.fetches))
        yield Sample("expert_prefetches_total", "counter",
                     float(self.prefetches))
        yield Sample("expert_prefetched_bytes_total", "counter",
                     float(self.prefetched_bytes))
        yield Sample("expert_misroute_stalls_total", "counter",
                     float(self.misroute_stalls))
        yield Sample("expert_misroute_stall_seconds_total", "counter",
                     float(self.misroute_stall_s))
        yield Sample("expert_cache_hit_rate", "gauge",
                     self.hits / max(self.hits + self.misses, 1))


class ExpertPrefetcher:
    """Background fetcher filling the ExpertCache ahead of the router.

    ``fetch(layer, expert) -> (device_value, nbytes)`` is supplied by the
    engine (it knows the store layout). ``request`` enqueues predicted
    ``(layer, expert)`` keys; the worker thread fetches any that are
    neither resident nor already in flight and inserts them (plain LRU
    insert — the cache's eviction discipline decides what makes room).
    A prefetched-but-wrong expert costs wasted bytes, never correctness:
    the compute path always fetches what the router actually asked for.
    """

    def __init__(self, cache: ExpertCache,
                 fetch: Callable[[int, int], tuple[object, int]],
                 discard: Callable[[object], None] | None = None,
                 batch_fetch=None):
        self.cache = cache
        self._fetch = fetch
        # cleanup for a fetched value the cache rejected (page-pool engines
        # free the orphaned slots; nothing references them afterwards)
        self._discard = discard
        # optional ``batch_fetch(keys) -> {key: (value, nbytes)}``: the
        # worker drains its whole queue into ONE call, so a burst of
        # predictions (the engine requests a full step of layers at once)
        # costs one staged pool transfer instead of one per expert.
        self._batch_fetch = batch_fetch
        self._q: "queue.Queue" = queue.Queue()
        self._inflight: set = set()
        # fetch-round accounting: ``batches`` counts worker fetch rounds
        # (with batch_fetch, each round is ONE staged pool transfer),
        # ``batched_keys`` the keys they carried: batched_keys / batches is
        # the amortization (a burst of predictions must not degenerate
        # into one transfer per expert).
        self.batches = 0
        self.batched_keys = 0
        # fault accounting: a failed prefetch is only a lost optimization
        # (the compute path re-fetches synchronously), but it must be
        # COUNTED, and each distinct error logged once — never silently
        # dropped (a store whose every prefetch read faults would
        # otherwise look like an inexplicably cold cache).
        self.prefetch_failures = 0
        self._seen_errors: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def request(self, keys: Iterable[tuple[int, int]]):
        for key in keys:
            with self._lock:
                if key in self._inflight:
                    continue
                self._inflight.add(key)
            self._q.put(key)

    def in_flight(self, key) -> bool:
        """True while ``key`` is queued or being fetched — the compute
        path waits for it instead of double-reading the same pages."""
        with self._lock:
            return key in self._inflight

    def _worker(self):
        while not self._stop.is_set():
            try:
                keys = [self._q.get(timeout=0.05)]
            except queue.Empty:
                continue
            # drain the backlog: one burst of predictions, one fetch round
            # (with batch_fetch, one staged pool transfer)
            while True:
                try:
                    keys.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                if any(k is None for k in keys):
                    return
                todo = [k for k in keys if k not in self.cache]
                if todo:
                    with self._lock:
                        self.batches += 1
                        self.batched_keys += len(todo)
                if todo and self._batch_fetch is not None:
                    fetched = self._batch_fetch(todo)
                else:
                    fetched = {k: self._fetch(*k) for k in todo}
                for key, (value, nbytes) in fetched.items():
                    self.cache.note_fetch(nbytes, prefetch=True)
                    if (not self.cache.insert(key, value, nbytes)
                            and self._discard is not None):
                        self._discard(value)
            except Exception as e:
                # a failed prefetch is only a lost optimization — the
                # compute path re-fetches synchronously and surfaces the
                # real error there — but it is counted, and each distinct
                # error is logged ONCE (not per occurrence: an injected
                # fault burst would flood the log).
                sig = f"{type(e).__name__}: {e}"
                with self._lock:
                    self.prefetch_failures += 1
                    first = sig not in self._seen_errors
                    self._seen_errors.add(sig)
                if first:
                    logging.getLogger(__name__).warning(
                        "expert prefetch failed (compute path will "
                        "re-fetch synchronously): %s", sig)
            finally:
                with self._lock:
                    for key in keys:
                        self._inflight.discard(key)

    def stats(self) -> dict:
        with self._lock:
            return {"prefetch_batches": self.batches,
                    "prefetch_batched_keys": self.batched_keys,
                    "prefetch_failures": self.prefetch_failures}

    def obs_samples(self):
        yield Sample("expert_prefetch_batches_total", "counter",
                     float(self.batches))
        yield Sample("expert_prefetch_batched_keys_total", "counter",
                     float(self.batched_keys))
        yield Sample("expert_prefetch_failures_total", "counter",
                     float(self.prefetch_failures))

    def drain(self, timeout: float = 5.0):
        """Block until the queue is empty and nothing is in flight
        (tests / deterministic shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = self._q.empty() and not self._inflight
            if idle:
                return
            time.sleep(0.002)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
