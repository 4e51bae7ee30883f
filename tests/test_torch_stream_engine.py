"""The streamed plane as a whole: the port's ``Engine(OPT_TINY,
weight_store=PageStore(), stream_cfg=StreamConfig(...), device="cpu")``
(plain kernel versions), on params carried across from
``dense.init(OPT_TINY, PRNGKey(0))``, against the JAX streamed engine in
tests/test_stream_engine.py's scenarios: the same greedy tokens, with the
weight tier really streamed under a budget, pinned, served from a JAX die
image, and through fetch faults. Plus its logits against the port's own
resident engine, step by step."""
from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.models import dense as jdense
from repro.serving.engine import Engine as JEngine
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.core.scheduler import AdmissionConfig
from repro_torch.core.tiering import dram_tier
from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
from repro_torch.serving.engine import Engine
from repro_torch.store import PageStore, StreamConfig
from repro_torch.store.faults import StoreFault

torch.set_num_threads(2)

MAX_SEQ = 96


def _serve(eng):
    """tests/test_stream_engine.py's workload: a chunked prefill beside a
    short prompt."""
    r1 = eng.submit(list(range(1, 30)), max_new=8)
    r2 = eng.submit([9, 8], max_new=8)
    out = eng.run()
    return [out[r1], out[r2]]


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


@pytest.fixture(scope="module")
def jax_streamed(jax_params):
    """The JAX streamed engine (group_size=1) after the workload: its
    tokens are the reference; its store is a JAX-programmed die."""
    store = JPageStore(n_planes=8)
    eng = JEngine(J_OPT_TINY, jax_params, max_slots=2, max_seq=MAX_SEQ,
                  weight_store=store,
                  stream_cfg=JStreamConfig(group_size=1))
    return _serve(eng), store


@pytest.fixture(scope="module")
def tier_bytes(params):
    probe = PageStore()
    Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
           weight_store=probe, stream_cfg=StreamConfig(pin_edges=False),
           device="cpu")
    return probe.total_bytes


def _streamed(params, **stream_kw):
    store = PageStore(n_planes=8)
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                 weight_store=store, stream_cfg=StreamConfig(**stream_kw),
                 device="cpu")
    return eng, store


def _no_leak(eng):
    """Every pool slot in use belongs to a cache-resident window."""
    resident = sum(eng.store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident


def test_streamed_matches_the_reference(params, jax_streamed):
    eng, store = _streamed(params, group_size=1)
    assert _serve(eng) == jax_streamed[0]
    # the die the port programmed is the reference's, page for page
    js = jax_streamed[1]
    assert store.n_pages == js.n_pages
    np.testing.assert_array_equal(store._data[:store.n_pages],
                                  np.asarray(js._data[:js.n_pages]))
    _no_leak(eng)


def test_streamed_under_a_budget_smaller_than_the_tier(params, jax_streamed,
                                                       tier_bytes):
    """A device weight budget smaller than the flash tier still serves the
    reference's tokens, and really streams: one staged pool upload per
    streamed window, no pool growth, no leaked slots."""
    budget = int(tier_bytes * 0.7)
    eng, store = _streamed(params, group_size=1, prefetch_depth=2,
                           device_budget_bytes=budget)
    assert store.total_bytes > budget
    assert _serve(eng) == jax_streamed[0]
    st = eng.stream_stats()
    assert st["bytes_streamed"] > 0 and st["groups_streamed"] > 0
    assert st["pages_read"] > 0 and st["nand_seconds"] > 0
    assert st["pool_uploads"] == st["groups_streamed"]
    assert st["pool_grows"] == 0
    assert st["cache_bytes_used"] <= budget
    assert all(0.0 <= s["stall_frac"] <= 1.0 for s in eng.stats)
    _no_leak(eng)


def test_pin_all_streams_nothing(params, jax_streamed):
    eng, _ = _streamed(params, group_size=2, pin_all=True)
    assert _serve(eng) == jax_streamed[0]
    st = eng.stream_stats()
    assert st["bytes_streamed"] == 0 and st["pool_uploads"] == 0
    assert st["cache_hits"] > 0 and st["cache_misses"] == 0


def test_hot_pins(params, jax_streamed):
    """lm_head and the first/last layer groups are pinned when the budget
    allows; the middle streams and the pinned edges hit every step."""
    eng, _ = _streamed(params, group_size=1)
    assert _serve(eng) == jax_streamed[0]
    assert "lm_head" in eng.cache
    assert 0 in eng.cache and eng.n_groups - 1 in eng.cache
    assert eng.stream_stats()["cache_hits"] > 0


def test_serves_a_jax_die_image(params, jax_streamed, tmp_path):
    """A die image the JAX engine programmed (flash tier + attn flash
    copies), opened read-only: StoreRefs rebuilt from its page table,
    nothing programmed, the reference's tokens."""
    img = str(tmp_path / "nand.img")
    jax_streamed[1].save(img)
    opened = PageStore.open(img)
    n_pages = opened.n_pages
    eng = Engine(OPT_TINY, dram_tier(params), max_slots=2, max_seq=MAX_SEQ,
                 weight_store=opened, stream_cfg=StreamConfig(group_size=1),
                 device="cpu")
    assert eng.store_preprogrammed and opened.n_pages == n_pages
    assert _serve(eng) == jax_streamed[0]
    with pytest.raises(ValueError, match="rber"):
        Engine(OPT_TINY, dram_tier(params), weight_store=opened, rber=1e-4,
               device="cpu")


def test_read_only_image_without_attn_copies_rejected(params, tmp_path):
    from repro_torch.core.tiering import deploy
    store = PageStore()
    deploy(params, store=store)                   # no attn copies
    img = str(tmp_path / "bare.img")
    store.save(img)
    with pytest.raises(ValueError, match="attn flash copies"):
        Engine(OPT_TINY, dram_tier(params), max_slots=2, max_seq=MAX_SEQ,
               weight_store=PageStore.open(img),
               stream_cfg=StreamConfig(group_size=1), device="cpu")


def test_bad_configs_rejected(params):
    with pytest.raises(ValueError, match="device_budget"):
        _streamed(params, group_size=1, device_budget_bytes=1024)
    with pytest.raises(ValueError, match="group_size"):
        _streamed(params, group_size=3)          # OPT_TINY has 4 layers


def test_transient_fetch_failure_recovers(params, jax_streamed):
    """A window fetch that fails once is retried by the worker with
    backoff: the reference's tokens, one retry counted."""
    eng, _ = _streamed(params, group_size=1)
    eng.streamer.retry_backoff_s = 0.001
    orig = eng.streamer._window
    calls = {"n": 0}

    def flaky(g):
        calls["n"] += 1
        if calls["n"] == 3:
            raise IOError("injected transient channel fault")
        return orig(g)

    eng.streamer._window = flaky
    assert _serve(eng) == jax_streamed[0]
    st = eng.streamer.stats()
    assert st["fetch_retries"] == 1 and st["fetch_faults"] == 0
    _no_leak(eng)


def test_persistent_fetch_failure_raises_storefault(params):
    """A fetch failing past the retry budget surfaces as a typed
    StoreFault out of step(); close() then returns promptly."""
    eng, _ = _streamed(params, group_size=1)
    eng.streamer.retry_backoff_s = 0.001
    eng.streamer.max_fetch_retries = 1

    def dead(g):
        raise IOError("dead channel")

    eng.submit([1, 2, 3], max_new=2)
    eng.streamer._window = dead
    with pytest.raises(StoreFault) as ei:
        eng.step()
    assert isinstance(ei.value.__cause__, IOError)
    assert eng.streamer.stats()["fetch_faults"] == 1
    assert eng.streamer.stats()["fetch_retries"] == 1
    t = threading.Thread(target=eng.close)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "Engine.close() hung after a streamer fault"
    _no_leak(eng)


def test_stall_fraction_contracts_the_prefill_share(params):
    def prefill_first_step(stall_frac):
        eng, _ = _streamed(params, group_size=1)
        eng.submit([5, 6], max_new=30)
        for _ in range(3):
            eng.step()
        eng._stall_frac = stall_frac
        eng.submit(list(range(1, 40)), max_new=4)
        eng.step()
        return eng.stats[-1]["prefill_tokens"]

    assert 0 <= prefill_first_step(0.95) < prefill_first_step(0.0)


def test_auto_depth_retunes_within_the_budget(params, tier_bytes):
    budget = int(tier_bytes * 0.7)
    eng, _ = _streamed(params, group_size=1, prefetch_depth=1,
                       device_budget_bytes=budget, auto_depth=True,
                       auto_depth_after=3)
    rid = eng.submit(list(range(1, 20)), max_new=12)
    got = eng.run()[rid]
    assert eng._auto_depth_done
    depth = eng.streamer.prefetch_depth
    afford = (budget - eng.cache.pinned_bytes) // eng._group_bytes
    assert 1 <= depth <= max(afford, 1)
    assert eng.cache.bytes_used <= max(eng.cache.capacity,
                                       eng.cache.pinned_bytes)
    ref = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                 device="cpu")
    r = ref.submit(list(range(1, 20)), max_new=12)
    assert ref.run()[r] == got


def test_logits_equal_the_resident_engine_each_step(params):
    """Streamed under a budget vs resident, in lockstep at RBER 1e-4: the
    same bytes and the same math, so the same logits bit for bit, and the
    launch counts on the CPU stay zero (plain versions)."""
    # a budget whose stall contraction never binds (at worst 512/16 = 32 =
    # 2 slots x 16 lanes): both engines plan the same steps
    kw = dict(max_slots=2, max_seq=MAX_SEQ, rber=1e-4, seed=1, device="cpu",
              admission_cfg=AdmissionConfig(token_budget=512))
    res = Engine(OPT_TINY, params, **kw)
    store = PageStore(n_planes=8)
    probe = PageStore()
    Engine(OPT_TINY, params, weight_store=probe, **kw)
    stm = Engine(OPT_TINY, params, weight_store=store,
                 stream_cfg=StreamConfig(
                     device_budget_bytes=int(probe.total_bytes * 0.6)),
                 **kw)
    before = (ecdp.ecdp_matmul.launches, paged_ecdp.paged_ecdp_matmul.launches,
              paged_attn.paged_attn.launches)
    for e in (res, stm):
        e.submit(list(range(3, 40)), max_new=6)
        e.submit([7, 1, 5], max_new=6)
    steps = 0
    while True:
        n_res, n_stm = res.step(), stm.step()
        assert n_res == n_stm
        if n_res == 0:
            break
        assert torch.equal(res.last_logits, stm.last_logits), steps
        steps += 1
    assert steps > 5 and stm.stream_stats()["bytes_streamed"] > 0
    assert [r.out for r in res.requests.values()] == \
        [r.out for r in stm.requests.values()]
    assert (ecdp.ecdp_matmul.launches, paged_ecdp.paged_ecdp_matmul.launches,
            paged_attn.paged_attn.launches) == before
