"""The port's ``ExpertCache`` and ``ExpertPrefetcher`` beside the
reference's (``repro.store.expert_cache``), in tests/test_expert_cache.py's
scenarios: every scenario runs the same op sequence on both caches and
expects the same decisions (insert / acquire / would_admit results, the
resident keys), the same predictions and the same counters; the
hypothesis property and the evict/prefetch race hold the invariants on the
port's cache. No tolerance anywhere: everything compared is exact."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from hyp_compat import given, settings, st
from repro.store import ExpertCache as JCache
from repro.store import ExpertPrefetcher as JPrefetcher
from repro_torch.store import ExpertCache as TCache
from repro_torch.store import ExpertPrefetcher as TPrefetcher

CAP = 100
PKGS = {"ref": (JCache, JPrefetcher), "port": (TCache, TPrefetcher)}


def _caches(cap=CAP, layers=4, experts=8, **kw):
    return {p: cls(cap, n_layers=layers, n_experts=experts, **kw)
            for p, (cls, _) in PKGS.items()}


def _state(c) -> dict:
    """Everything a cache decides and counts, comparable across packages."""
    s = c.stats()
    s["keys"] = sorted(c._entries)
    s["pinned_keys"] = sorted(k for k, e in c._entries.items() if e.pinned)
    s["refs"] = sorted((k, e.refs) for k, e in c._entries.items())
    s["capacity"] = c.capacity
    s["scores"] = c.scores.tolist()
    return s


def _same(run, **kw):
    """Run ``run(cache)`` on both caches; their returns and states match.
    Returns the port's cache and what ``run`` returned on it."""
    cs = _caches(**kw)
    outs = {p: run(c) for p, c in cs.items()}
    assert outs["port"] == outs["ref"]
    assert _state(cs["port"]) == _state(cs["ref"])
    return cs["port"], outs["port"]


# --- residency decisions -------------------------------------------------------

def test_keyed_by_layer_expert():
    def run(c):
        r = [c.insert((0, 3), "A", 40), c.insert((1, 3), "B", 40),
             c.acquire((0, 3)), c.acquire((1, 3))]
        c.release((0, 3))
        c.release((1, 3))
        return r
    c, r = _same(run)
    assert r == [True, True, "A", "B"]
    assert c.stats()["hits"] == 2 and c.stats()["misses"] == 0


def test_budget_never_exceeded_and_pinned_survive():
    def run(c):
        return [c.insert((0, 0), 0, 60, pin=True), c.insert((0, 1), 1, 50),
                c.insert((0, 2), 2, 40), c.bytes_used, c.pinned_bytes]
    c, r = _same(run)
    assert r[:3] == [True, False, True] and r[3] <= CAP
    assert (0, 0) in c and (0, 1) not in c


def test_release_floor_no_double_free():
    def run(c):
        r = [c.insert((0, 0), 0, 30), c.acquire((0, 0))]
        for _ in range(3):
            c.release((0, 0))              # the second and third: no-ops
        c.observe(1, [0])                  # (1, 0) outranks cold (0, 0)
        r.append(c.insert((1, 0), 1, CAP - 30 + 10))
        return r + [(0, 0) in c, (1, 0) in c]
    _, r = _same(run)
    assert r == [True, 0, True, False, True]


def test_score_aware_admission_never_thrashes_equals():
    def run(c):
        r = [c.insert((0, 0), "a", 50), c.insert((0, 1), "b", 50),
             c.insert((0, 2), "c", 50)]     # equal (zero) score: rejected
        for _ in range(3):
            c.observe(0, [2])              # expert 2 becomes hot
        r.append(c.insert((0, 2), "c", 50))    # displaces a cold resident
        return r
    c, r = _same(run)
    assert r == [True, True, False, True]
    assert c.stats()["rejects"] == 1 and c.bytes_used <= 100


def test_would_admit_matches_insert():
    def run(c):
        r = [c.insert((0, 0), "a", 60), c.would_admit((0, 0), 60),
             c.would_admit((0, 1), 40), c.would_admit((0, 2), 60)]
        c.observe(0, [2])
        r += [c.would_admit((0, 2), 60), c.acquire((0, 0)),
              c.would_admit((0, 2), 60)]      # ref-held: protected
        c.release((0, 0))
        return r
    _, r = _same(run)
    assert r == [True, False, True, False, True, "a", False]


def test_resize_trims_and_reports():
    """``resize`` (the automatic expert budget's lever) trims unpinned,
    ref-free entries eagerly in both packages, in the same order."""
    def run(c):
        for e in range(5):
            c.insert((0, e), e, 20, pin=e == 0)
        c.acquire((0, 1))
        c.resize(50)
        r = sorted(c._entries)
        c.release((0, 1))
        c.resize(None)
        return r + [c.insert((1, 0), 0, 500)]
    _, r = _same(run)
    assert (0, 0) in r and (0, 1) in r


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["ins", "pin", "acq", "rel",
                                           "obs", "adm"]),
                          st.integers(0, 3), st.integers(0, 5),
                          st.integers(1, 60)),
                max_size=50))
def test_expert_cache_invariants_property(ops):
    """tests/test_expert_cache.py's property on both caches, step by step:
    the same decisions and states, and on the port's: bytes_used <=
    capacity, pinned / ref-held entries survive every eviction, hits +
    misses == acquires. ``obs`` and ``adm`` add the predictor's updates
    and the admission pre-check to the reference's op mix."""
    cs = _caches()
    pinned, held = set(), {}
    acquires = 0
    for op, li, e, nbytes in ops:
        key = (li, e)
        outs = {}
        for p, c in cs.items():
            if op == "ins":
                outs[p] = c.insert(key, key, nbytes)
            elif op == "pin":
                outs[p] = c.insert(key, key, nbytes, pin=True)
            elif op == "acq":
                outs[p] = c.acquire(key)
            elif op == "rel" and held.get(key):
                c.release(key)
            elif op == "obs":
                c.observe(li, [e, (e + nbytes) % 6])
            elif op == "adm":
                outs[p] = c.would_admit(key, nbytes)
        assert outs.get("port") == outs.get("ref")
        if op == "pin" and outs["port"]:
            pinned.add(key)
        elif op == "acq":
            acquires += 1
            if outs["port"] is not None:
                held[key] = held.get(key, 0) + 1
        elif op == "rel" and held.get(key):
            held[key] -= 1
        c = cs["port"]
        assert _state(c) == _state(cs["ref"])
        s = c.stats()
        assert s["bytes_used"] <= CAP
        assert s["hits"] + s["misses"] == acquires
        for k in pinned | {k for k, v in held.items() if v > 0}:
            assert k in c, f"pinned/held expert {k} was evicted"


def test_evict_prefetch_race_invariants():
    """Concurrent prefetch-style inserts racing the compute path's
    acquire / release / insert traffic on the port's cache: the budget
    holds at every moment, the pinned entry survives, the counters stay
    consistent."""
    c = TCache(200, n_layers=2, n_experts=16)
    c.insert((0, 0), "pin", 50, pin=True)
    stop = threading.Event()
    errors: list = []

    def prefetcher():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            li, e = int(rng.integers(2)), int(rng.integers(16))
            c.insert((li, e), (li, e), int(rng.integers(1, 40)))
            if c.bytes_used > 200:
                errors.append("budget exceeded")
                return

    t = threading.Thread(target=prefetcher, daemon=True)
    t.start()
    rng = np.random.default_rng(1)
    acquires = 0
    try:
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            li, e = int(rng.integers(2)), int(rng.integers(16))
            acquires += 1
            v = c.acquire((li, e))
            if v is None:
                c.insert((li, e), (li, e), int(rng.integers(1, 40)))
            else:
                assert c.bytes_used <= 200
                c.release((li, e))
            assert (0, 0) in c, "pinned expert evicted under race"
    finally:
        stop.set()
        t.join()
    assert not errors
    s = c.stats()
    assert s["bytes_used"] <= 200
    assert s["hits"] + s["misses"] == acquires


# --- the router-history predictor ------------------------------------------------

def test_predictor_ranks_observed_experts():
    def run(c):
        for _ in range(5):
            c.observe(0, [1, 5])
        c.observe(0, [2])
        return [c.predict(0, 2), c.predict(1, 4), c.predict(0, 8)]
    _, r = _same(run, layers=2, experts=8)
    assert set(r[0]) == {1, 5} and r[1] == []


def test_predictor_ema_decays_stale_experts():
    def run(c):
        c.observe(0, [0])
        for _ in range(6):
            c.observe(0, [3])
        return c.predict(0, 1)
    c, r = _same(run, layers=1, experts=4, ema_alpha=0.5)
    assert r == [3] and c.scores[0, 0] < c.scores[0, 3]


def test_per_slot_histories_and_hit_rates():
    """The per-slot planes: ``predict(slots=...)`` max-combines the active
    slots' histories with the global one, and ``note_slot_route`` feeds
    ``slot_hit_rates``, in both packages alike."""
    def run(c):
        c.observe(0, [1])
        c.observe_slot(0, 0, [4, 6])
        c.observe_slot(1, 0, [7])
        c.observe_slot(5, 0, [2])           # past n_slots: ignored
        c.note_slot_route(0, 3, 1)
        c.note_slot_route(1, 2, 2)
        c.note_slot_route(9, 4, 0)          # ignored
        return [c.predict(0, 3), c.predict(0, 8, slots=[0]),
                c.predict(0, 8, slots=[0, 1]), c.slot_hit_rates(),
                c.slot_scores.tolist()]
    _, r = _same(run, layers=2, experts=8, n_slots=2)
    assert r[0] == [1] and set(r[2]) == {1, 4, 6, 7}
    assert r[3] == [2 / 3, 0.0]


def test_note_fetch_and_stall_accounting():
    def run(c):
        c.note_fetch(100)
        c.note_fetch(50, prefetch=True)
        c.note_stall(0.25)
        s = c.stats()
        c.reset_counters()
        return [s, c.stats()["bytes_fetched"]]
    _, (s, after) = _same(run)
    assert s["bytes_fetched"] == 150 and s["fetches"] == 2
    assert s["prefetches"] == 1 and s["prefetched_bytes"] == 50
    assert s["misroute_stalls"] == 1 and s["misroute_stall_s"] == 0.25
    assert after == 0


def test_obs_samples_match_the_reference():
    """The scrape samples (names, kinds, values) of both caches after the
    same traffic."""
    def run(c):
        c.insert((0, 1), 1, 30)
        c.acquire((0, 1))
        c.acquire((0, 2))
        c.note_fetch(30, prefetch=True)
        c.note_stall(0.5)
        return [(s.name, s.kind, s.value) for s in c.obs_samples()]
    _, r = _same(run)
    assert ("expert_cache_hit_rate", "gauge", 0.5) in r


# --- the prefetch worker --------------------------------------------------------

def _fill_and_dedupe(pkg):
    cache_cls, pref_cls = PKGS[pkg]
    c = cache_cls(None, n_layers=2, n_experts=8)
    fetched: list = []

    def fetch(li, e):
        fetched.append((li, e))
        time.sleep(0.005)
        return (li, e), 10

    p = pref_cls(c, fetch)
    try:
        p.request([(0, 1), (0, 1), (0, 2)])    # the duplicate collapses
        p.request([(0, 1)])                    # in flight or resident: skip
        p.drain()
        first = sorted(fetched)
        p.request([(0, 2)])                    # resident: never re-fetched
        p.drain()
        return dict(first=first, fetched=sorted(fetched),
                    resident=sorted(c._entries),
                    prefetches=c.stats()["prefetches"],
                    failures=p.stats()["prefetch_failures"])
    finally:
        p.stop()


def test_prefetcher_fills_cache_and_dedupes():
    got, want = _fill_and_dedupe("port"), _fill_and_dedupe("ref")
    assert got == want
    assert got["fetched"] == [(0, 1), (0, 2)] == got["resident"]
    assert got["prefetches"] == 2


def test_prefetcher_batch_fetch_and_discard():
    """``batch_fetch`` takes the drained queue in one round, and a value
    the cache rejects goes to ``discard`` — in both packages alike."""
    out = {}
    for pkg, (cache_cls, pref_cls) in PKGS.items():
        c = cache_cls(25, n_layers=1, n_experts=8)
        c.insert((0, 0), "pinned", 20, pin=True)
        gate = threading.Event()
        rounds, discarded = [], []

        def batch(keys, rounds=rounds, gate=gate):
            gate.wait(5)
            rounds.append(sorted(keys))
            return {k: (k, 10) for k in keys}

        p = pref_cls(c, lambda li, e: ((li, e), 10),
                     discard=discarded.append, batch_fetch=batch)
        try:
            p.request([(0, 1)])
            time.sleep(0.05)                 # the worker holds (0, 1)
            p.request([(0, 2), (0, 3)])      # queued behind it: one round
            gate.set()
            p.drain()
            out[pkg] = dict(rounds=rounds, discarded=sorted(discarded),
                            resident=sorted(c._entries), **p.stats())
        finally:
            p.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["rounds"] == [[(0, 1)], [(0, 2), (0, 3)]]
    assert out["port"]["discarded"] == [(0, 1), (0, 2), (0, 3)]


def test_prefetcher_failure_is_non_fatal():
    for pkg, (cache_cls, pref_cls) in PKGS.items():
        c = cache_cls(None, n_layers=4, n_experts=8)

        def fetch(li, e):
            raise RuntimeError("flash read failed")

        p = pref_cls(c, fetch)
        try:
            p.request([(0, 0)])
            p.drain()
            assert (0, 0) not in c, pkg        # a lost optimization only
            assert p.stats()["prefetch_failures"] == 1, pkg
            assert not p.in_flight((0, 0)), pkg
        finally:
            p.stop()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_stop_joins_the_worker(pkg):
    cache_cls, pref_cls = PKGS[pkg]
    p = pref_cls(cache_cls(None, n_layers=1, n_experts=2),
                 lambda li, e: ((li, e), 1))
    p.stop()
    assert not p._thread.is_alive()
