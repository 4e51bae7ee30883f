"""The port's prefix cache (``serving/prefix.py``, ``PagedKVPool``'s shared
``alloc`` / ``ref`` / ``deref``, the engine's prefix admission and retain)
against the reference's: chain hashes byte-equal, the index's insert /
lookup / eviction, shared admission (host and device lengths start past
the hit), a warm hit emitting the JAX engine's greedy tokens with fewer
prefill lanes, and the pool-conservation property run side by side with
the reference's ``PrefixIndex``."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hyp_compat import given, settings, st

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.models import dense as jdense
from repro.serving import kvcache as jkv
from repro.serving import prefix as jprefix
from repro.serving.engine import Engine as JEngine
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.serving.engine import Engine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.prefix import PrefixIndex, block_hashes

torch.set_num_threads(2)

MAX_SEQ = 96
BS = 16


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def _pool(n_slots=2, n_blocks=None):
    return PagedKVPool(n_layers=1, n_slots=n_slots, max_seq=MAX_SEQ,
                       n_kv_heads=1, head_dim=4, block_size=BS,
                       n_blocks=n_blocks, device="cpu")


def _jpool(n_slots=2, n_blocks=None):
    return jkv.PagedKVPool(n_layers=1, n_slots=n_slots, max_seq=MAX_SEQ,
                           n_kv_heads=1, head_dim=4, block_size=BS,
                           n_blocks=n_blocks)


def _prefill(pool, rid, n_tokens):
    slot = pool.alloc(rid, n_tokens)
    pool.ensure(slot, n_tokens)
    pool.bump(slot, n_tokens)
    return slot


@pytest.mark.parametrize("case", [
    (list(range(40)), None), (list(range(40)), 1), (list(range(15)), None),
    ([1] * BS + [7] * BS, None), ([11, 2] + [0] * 14, None),
    ([1, 12] + [0] * 14, None), ([3] * (5 * BS + 3), 4),
    (list(range(1000, 1000 + 3 * BS)), None)])
def test_block_hashes_equal_the_reference(case):
    toks, limit = case
    assert block_hashes(toks, BS, limit=limit) == \
        jprefix.block_hashes(toks, BS, limit=limit)
    assert block_hashes(np.asarray(toks), BS) == \
        jprefix.block_hashes(toks, BS)


def test_index_insert_lookup_evict_matches_the_reference():
    """The same operations on both packages' pool + index: the same
    lookups, ref counts, free lists and eviction order."""
    sides = [(_pool(), PrefixIndex), (_jpool(), jprefix.PrefixIndex)]
    got = []
    for pool, index_cls in sides:
        idx = index_cls(pool)
        slot = _prefill(pool, 0, 3 * BS)
        hashes = block_hashes(list(range(3 * BS)), BS)
        blocks = [int(b) for b in pool.block_tables[slot, :3]]
        log = [idx.insert(hashes, blocks), idx.lookup(hashes),
               idx.lookup(hashes[:2]),
               idx.lookup(block_hashes([99] * (2 * BS), BS)),
               [int(pool.ref_count[b]) for b in blocks], idx.evict(3)]
        pool.release(slot)
        log += [[int(pool.ref_count[b]) for b in blocks], idx.evict(1),
                hashes[2] in idx, hashes[1] in idx, idx.evict(10), len(idx),
                sorted(pool.free_blocks), idx.stats()]
        got.append(log)
    assert got[0] == got[1]
    assert got[0][0] == 3 and got[0][5] == 0 and got[0][7] == 1


def test_insert_never_rebinds():
    pool = _pool()
    idx = PrefixIndex(pool)
    hashes = block_hashes(list(range(2 * BS)), BS)
    s1 = _prefill(pool, 0, 2 * BS)
    b1 = [int(b) for b in pool.block_tables[s1, :2]]
    idx.insert(hashes, b1)
    s2 = _prefill(pool, 1, 2 * BS)
    b2 = [int(b) for b in pool.block_tables[s2, :2]]
    assert idx.insert(hashes, b2) == 0
    assert idx.lookup(hashes) == b1
    pool.release(s2)
    assert all(int(pool.ref_count[b]) == 0 for b in b2)


def test_shared_alloc_adopts_and_sets_both_lengths():
    """A shared-prefix admission maps the hit at the head of the table,
    reserves only the tail, and starts the slot's host AND device lengths
    at the cached length."""
    pool = _pool()
    idx = PrefixIndex(pool)
    slot = _prefill(pool, 0, 2 * BS)
    hashes = block_hashes(list(range(2 * BS)), BS)
    blocks = [int(b) for b in pool.block_tables[slot, :2]]
    idx.insert(hashes, blocks)
    pool.release(slot)
    s2 = pool.alloc(1, 2 * BS + 8, shared_blocks=idx.lookup(hashes))
    assert [int(b) for b in pool.block_tables[s2, :2]] == blocks
    assert int(pool.lengths[s2]) == 2 * BS
    assert int(pool.lengths_dev[s2]) == 2 * BS
    assert int(pool.reserved[s2]) == 1
    assert all(int(pool.ref_count[b]) == 2 for b in blocks)
    pool.release(s2)
    assert all(int(pool.ref_count[b]) == 1 for b in blocks)
    s3 = pool.alloc(2, 8)                  # a cold admission starts at 0
    assert int(pool.lengths[s3]) == int(pool.lengths_dev[s3]) == 0
    with pytest.raises(AssertionError, match="tail"):
        pool.alloc(3, 2 * BS, shared_blocks=idx.lookup(hashes))


def _conserved(pool, idx):
    """Every block is free, or has ref_count = (#table mappings) + (1 if
    cached)."""
    maps = np.zeros(pool.n_blocks, np.int64)
    for s in range(pool.n_slots):
        for b in pool.block_tables[s]:
            if int(b):
                maps[int(b)] += 1
    cached = np.zeros(pool.n_blocks, np.int64)
    for e in idx.entries.values():
        cached[e.block] += 1
    assert cached.max(initial=0) <= 1
    free = set(pool.free_blocks)
    assert len(free) == len(pool.free_blocks)
    for b in range(1, pool.n_blocks):
        want = int(maps[b] + cached[b])
        assert int(pool.ref_count[b]) == want, f"block {b}"
        assert (b in free) == (want == 0)


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_prefix_pool_conservation_beside_the_reference(data):
    """Random interleavings of admit (shared when cached) / finish (retain)
    / cancel / evict on both packages' pool + index: conservation after
    every operation, and the two sides' tables, ref counts, free lists
    and lengths stay equal."""
    sides = [(_pool(n_slots=3, n_blocks=16), PrefixIndex),
             (_jpool(n_slots=3, n_blocks=16), jprefix.PrefixIndex)]
    sides = [(pool, cls(pool)) for pool, cls in sides]
    prompts = [[p * 31 + t for t in range(n * BS)]
               for p, n in ((1, 1), (2, 2), (3, 3), (4, 2))]
    live: dict[int, list] = {}
    rid = 0
    for _ in range(data.draw(st.integers(5, 40), label="ops")):
        op = data.draw(st.sampled_from(
            ["admit", "finish", "cancel", "evict"]), label="op")
        pool0 = sides[0][0]
        if op == "admit" and pool0.free_slots:
            toks = data.draw(st.sampled_from(prompts), label="prompt")
            slots = []
            for pool, idx in sides:
                hashes = block_hashes(toks, BS,
                                      limit=(len(toks) + BS - 1) // BS - 1)
                shared = idx.lookup(hashes)
                need = len(toks) + 4
                slot = pool.alloc(rid, need, shared_blocks=shared)
                if slot is None and idx.evict(pool.blocks_for(need)
                                              - len(shared)) > 0:
                    shared = idx.lookup(hashes)
                    slot = pool.alloc(rid, need, shared_blocks=shared)
                if slot is not None:
                    pool.ensure(slot, len(toks))
                    pool.bump(slot, len(toks) - int(pool.lengths[slot]))
                slots.append(slot)
            assert slots[0] == slots[1]
            if slots[0] is not None:
                live[slots[0]] = block_hashes(toks, BS)
                rid += 1
        elif op in ("finish", "cancel") and live:
            slot = data.draw(st.sampled_from(sorted(live)), label="slot")
            hashes = live.pop(slot)
            for pool, idx in sides:
                if op == "finish":
                    idx.insert(hashes, [int(b) for b in
                                        pool.block_tables[slot,
                                                          :len(hashes)]])
                pool.release(slot)
        elif op == "evict":
            n = data.draw(st.integers(1, 4), label="n")
            assert sides[0][1].evict(n) == sides[1][1].evict(n)
        (tp, ti), (jp, ji) = sides
        _conserved(tp, ti)
        np.testing.assert_array_equal(tp.block_tables, jp.block_tables)
        np.testing.assert_array_equal(tp.ref_count, jp.ref_count)
        np.testing.assert_array_equal(tp.lengths, jp.lengths)
        np.testing.assert_array_equal(tp.lengths_dev.numpy(),
                                      np.asarray(jp.lengths_dev))
        assert tp.free_blocks == jp.free_blocks
        assert ti.stats() == ji.stats()
    for slot in list(live):
        for pool, _ in sides:
            pool.release(slot)
    for pool, idx in sides:
        idx.evict(len(idx))
        assert sorted(pool.free_blocks) == list(range(1, pool.n_blocks))


# --- engine level ---------------------------------------------------------------

SYSTEM = list(range(1, 40))              # 2 full blocks + a tail


@pytest.fixture(scope="module")
def jax_warm(jax_params):
    """The JAX engine with prefix_cache=True: the same prompt cold, then
    warm — its tokens and prefill lanes."""
    eng = JEngine(J_OPT_TINY, jax_params, max_slots=2, max_seq=MAX_SEQ,
                  rber=0.0, prefix_cache=True)
    r1 = eng.submit(SYSTEM + [50, 51], max_new=8)
    eng.run()
    start = len(eng.stats)
    r2 = eng.submit(SYSTEM + [50, 51], max_new=8)
    outs = eng.run()
    return (outs[r1], outs[r2],
            sum(s["prefill_tokens"] for s in eng.stats[:start]),
            sum(s["prefill_tokens"] for s in eng.stats[start:]),
            eng.prefix_stats())


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "eager"])
def test_warm_hit_emits_the_reference_tokens_with_fewer_lanes(
        params, jax_warm, compiled):
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                 prefix_cache=True, device="cpu", compiled=compiled)
    r1 = eng.submit(SYSTEM + [50, 51], max_new=8)
    eng.run()
    start = len(eng.stats)
    r2 = eng.submit(SYSTEM + [50, 51], max_new=8)
    assert eng.requests[r2].cached_len == 2 * BS
    outs = eng.run()
    cold = sum(s["prefill_tokens"] for s in eng.stats[:start])
    warm = sum(s["prefill_tokens"] for s in eng.stats[start:])
    j1, j2, jcold, jwarm, jstats = jax_warm
    assert (outs[r1], outs[r2]) == (j1, j2) and j1 == j2
    assert (cold, warm) == (jcold, jwarm) and warm == cold - 2 * BS
    assert eng.prefix_stats() == jstats
    assert eng.prefix_stats()["prefix_prefill_tokens_saved"] == 2 * BS
    _conserved(eng.pool, eng.prefix)
    assert eng.step_traces == (0 if compiled else -1)


def test_two_concurrent_sharers(params):
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                 prefix_cache=True, device="cpu")
    r0 = eng.submit(SYSTEM + [50], max_new=6)
    eng.run()
    want = eng.requests[r0].out
    ra = eng.submit(SYSTEM + [50], max_new=6)
    rb = eng.submit(SYSTEM + [50], max_new=6)
    eng.step()
    shared = [int(b) for b in eng.pool.block_tables[
        eng.requests[ra].slot, :2]]
    assert shared == [int(b) for b in eng.pool.block_tables[
        eng.requests[rb].slot, :2]]
    assert all(int(eng.pool.ref_count[b]) == 3 for b in shared)
    outs = eng.run()
    assert outs[ra] == want and outs[rb] == want
    _conserved(eng.pool, eng.prefix)


def test_cancelled_request_never_inserts(params):
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                 prefix_cache=True, device="cpu")
    rid = eng.submit(list(range(1, 40)), max_new=32)
    eng.step()
    assert eng.cancel(rid)
    eng.step()
    assert len(eng.prefix) == 0
    assert eng.requests[rid].slot not in eng.pool.active
    _conserved(eng.pool, eng.prefix)
    assert not eng.cancel(rid)


def test_eviction_under_admission_pressure(params):
    """A pool that holds two worst-case requests: cached chains are evicted
    to admit fresh prompts, and serving never wedges or leaks."""
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                 prefix_cache=True, device="cpu",
                 n_blocks=2 * 3 + 1)      # 39 + 3 KV rows = 3 blocks each
    for wave in range(3):
        eng.submit([wave * 97 + t for t in range(1, 40)], max_new=4)
        eng.submit([wave * 89 + t for t in range(1, 40)], max_new=4)
        eng.run()
        _conserved(eng.pool, eng.prefix)
    assert eng.prefix.evicted > 0
    assert all(r.done for r in eng.requests.values())
