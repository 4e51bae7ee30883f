"""The streamed MoE plane on the CPU (plain kernel versions): the grouped
paged ECDP's plain version against the reference's per-expert paged ECDP,
the host expert-id handoff (``routed_experts``) against the reference's,
and the port's expert-paged ``Engine(cfg, params, weight_store=PageStore(),
device="cpu")`` in tests/test_moe_serving.py's streamed scenarios at
qwen3-moe-30b-a3b-smoke (8 experts, top 2), on the JAX init's params
carried across by ``interop``: the JAX streamed MoE engine's greedy tokens
(one JAX engine for the module), the port's resident engine's logits bit
for bit, a budget smaller than the expert tier, pins, grouped routing,
per-slot stats, the automatic expert budget, the refusals, the worker's
stop, speculative lanes, a JAX die image and the stats the serving front
exposes. Counters the prefetch thread's timing can move are held as
invariants (hits + misses == acquires, capacity never exceeded), or equal
to the reference's with the prefetcher off in both. Tolerances are stated
where a float is compared; tokens and counters are exact."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import scheduler as jsched
from repro.core import tiering as jtier
from repro.kernels.paged_ffn import paged_ecdp_matmul_xla
from repro.models import moe as jmoe
from repro.serving.engine import Engine as JEngine
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro.store import WeightPagePool as JPool
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import erdpe
from repro_torch.core import scheduler as tsched
from repro_torch.core.tiering import PagedWeight, deploy, dram_tier
from repro_torch.kernels import grouped_ecdp as tge
from repro_torch.kernels import paged_ecdp as tpe
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import ServeFront
from repro_torch.serving.spec import SpecConfig
from repro_torch.store import PageStore, StreamConfig, WeightPagePool

torch.set_num_threads(2)

ARCH = "qwen3-moe-30b-a3b"
CFG = get_config(ARCH, smoke=True)
MAX_SEQ = 96
# tests/test_moe_serving.py's pair (a 19-token prompt prefilled in chunks
# beside a 3-token one), margin-scanned on the port as in
# tests/test_torch_moe_engine.py (every emitted token's top-2 margin at
# least 0.025 at RBER 0)
PAIR = (list(range(33, 52)), [384, 8, 157])


@functools.lru_cache(maxsize=None)
def _params():
    jp = jmoe.init(jget(ARCH, smoke=True), jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _run(eng, prompts=PAIR, max_new=8, each_step=None):
    """Serve ``prompts``; returns (tokens per request, each step's logits,
    each step's mask of slots that ran lanes)."""
    rids = [eng.submit(list(p), max_new=max_new) for p in prompts]
    logits, live = [], []
    while eng.step():
        if hasattr(eng, "last_logits"):
            logits.append(eng.last_logits.clone())
            live.append(eng._host_in["q_lens"].numpy() > 0)
        if each_step is not None:
            each_step(eng)
    return [eng.requests[r].out for r in rids], logits, live


@functools.lru_cache(maxsize=None)
def _tier_bytes() -> int:
    probe = PageStore()
    deploy(_params()[1], store=probe)
    return probe.total_bytes


def _budget() -> int:
    """A device budget of 0.8 of the flash tier (tests/test_moe_serving.py's
    ratio): the expert cache must evict."""
    return int(_tier_bytes() * 0.8)


def _streamed(cfg=CFG, params=None, max_slots=2, **stream_kw):
    store = PageStore(n_planes=8)
    eng = Engine(cfg, _params()[1] if params is None else params,
                 max_slots=max_slots, max_seq=MAX_SEQ, weight_store=store,
                 stream_cfg=StreamConfig(**stream_kw), device="cpu")
    return eng, store


def _no_prefetch(eng):
    """Switch the router-history prefetch off (the engine's requests);
    every miss is then fetched on the compute path, deterministically."""
    eng._request_prefetch = lambda *a, **kw: None
    return eng


def _count_acquires(eng) -> list:
    calls = [0]
    real = eng.expert_cache.acquire

    def acquire(key):
        calls[0] += 1
        return real(key)
    eng.expert_cache.acquire = acquire
    return calls


@pytest.fixture(scope="module")
def jax_streamed():
    """The JAX streamed MoE engine under 0.8 of the tier with its prefetch
    off, after the pair: (tokens, expert_stats, the JAX-programmed store)."""
    store = JPageStore(n_planes=8)
    eng = JEngine(jget(ARCH, smoke=True), _params()[0], max_slots=2,
                  max_seq=MAX_SEQ, weight_store=store,
                  stream_cfg=JStreamConfig(device_budget_bytes=_budget()))
    _no_prefetch(eng)
    out = _run(eng)[0]
    st = eng.expert_stats()
    eng.close()
    return out, st, store


# --- the host expert-id handoff -----------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_routed_experts_are_the_reference_bytes(seed):
    """``routed_experts`` / ``routed_experts_by_slot`` (padding lanes
    filtered) give the reference's arrays: values, dtype and shape."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 16, (3, 5, 2)).astype(np.int32)
    for q_lens in (rng.integers(0, 6, 3), np.zeros(3, np.int64),
                   np.array([5, 0, 2])):
        got, want = (tsched.routed_experts(idx, q_lens),
                     jsched.routed_experts(idx, q_lens))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        got_s = tsched.routed_experts_by_slot(idx, q_lens)
        want_s = jsched.routed_experts_by_slot(idx, q_lens)
        assert list(got_s) == list(want_s)
        for s in want_s:
            assert got_s[s].tobytes() == want_s[s].tobytes()
    assert tsched.routed_experts(idx, [0, 0, 0]).size == 0


# --- the grouped paged ECDP's plain version ------------------------------------

def _slab(seed, n_experts, k, n, rber, rows):
    """``n_experts`` (K, N) experts in a JAX and a port store, uploaded into
    pools with one shuffled free list; returns (the port's FlashWeights,
    the JAX pool and tables, the port pool and the slab's stacked tables
    over the bank rows ``rows``)."""
    rng = np.random.default_rng(seed)
    js, ts = JPageStore(n_planes=4), PageStore(n_planes=4)
    tfws = []
    for e in range(n_experts):
        w = rng.standard_normal((k, n), dtype=np.float32)
        jfw = jtier.encode_flash(jnp.asarray(w), rber=rber, seed=e)
        tfw = interop.flash_from_numpy(jax.tree.map(np.asarray, jfw),
                                       device="cpu")
        js.put(f"e{e}", jfw)
        ts.put(f"e{e}", tfw)
        tfws.append(tfw)
    names = [f"e{e}" for e in range(n_experts)]
    n_pages = sum(ts.entry_pages(x) for x in names) + 3
    jpool, tpool = JPool(js, n_pages), WeightPagePool(ts, n_pages,
                                                      device="cpu")
    perm = [int(s) for s in rng.permutation(n_pages)]
    jpool._free, tpool._free = list(perm), list(perm)
    jt, tt = jpool.upload(names), tpool.upload(names)
    stacked = tuple(torch.stack([tt[f"e{e}"]["dev"][i] for e in rows])
                    for i in range(3))
    return tfws, (jpool.buffer, jt), tpool, stacked


@pytest.mark.parametrize("counts,k,n", [([3, 0, 5, 1], 128, 48),
                                        ([0, 7, 2, 0, 4], 264, 136),
                                        ([2, 2, 2], 200, 72)])
@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_grouped_paged_plain_matches_the_reference(counts, k, n, rber):
    """Over a slab (the bank's rows reversed), with ECC off as the engine
    reads the banks: the reference's per-expert ``paged_ecdp_matmul_xla``
    mapped over the slab (``jax.vmap``, ``ecc_enabled=False``) within
    test_paged_ffn.py's tolerance (rtol 1e-5, atol 1e-4: the XLA gather's
    f32 sums in another order), and ``grouped_ecdp_plain`` on the same
    bytes bit for bit, ECC on and off; no launch on the CPU."""
    rows = list(range(len(counts)))[::-1]
    tfws, (jbuf, jt), tpool, (qt, ps, ss) = _slab(sum(counts) + k, len(counts),
                                                  k, n, rber, rows)
    slab_counts = [counts[e] for e in rows]
    rs = torch.tensor(np.concatenate([[0], np.cumsum(slab_counts)]),
                      dtype=torch.int32)
    a = np.random.default_rng(k).standard_normal(
        (int(sum(counts)), k), dtype=np.float32)
    a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    before = tpe.grouped_paged_ecdp_matmul.launches
    got = tpe.grouped_paged_ecdp_matmul(ta, rs, tpool.buffer, qt, ps, ss,
                                        (k, n), ecc_enabled=False)
    assert tpe.grouped_paged_ecdp_matmul.launches == before
    # the reference: one paged ECDP per slab row over a (E, C, K) buffer
    c = max(slab_counts)
    buf = np.zeros((len(rows), c, k), np.float32)
    bounds = rs.tolist()
    for r in range(len(rows)):
        buf[r, :slab_counts[r]] = a[bounds[r]:bounds[r + 1]]
    tbl = [jnp.stack([jnp.asarray(jt[f"e{e}"][comp]) for e in rows])
           for comp in ("q_tbl", "p_slots", "s_slots")]
    xla = jax.vmap(lambda x, q, p, s: paged_ecdp_matmul_xla(
        x, jbuf, q, p, s, (k, n), ecc_enabled=False))(jnp.asarray(buf),
                                                       *tbl)
    want = np.zeros((a.shape[0], n), np.float32)
    for r in range(len(rows)):
        want[bounds[r]:bounds[r + 1]] = np.asarray(xla[r, :slab_counts[r]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    for ecc_on in (True, False):
        dense = [torch.stack([getattr(tfws[e], f) for e in rows])
                 for f in ("q", "parity", "scale")]
        assert torch.equal(
            tpe.grouped_paged_ecdp_matmul(ta, rs, tpool.buffer, qt, ps, ss,
                                          (k, n), ecc_enabled=ecc_on),
            tge.grouped_ecdp_plain(ta, rs, *dense, ecc_on))
    if rber:
        assert not torch.equal(got, tpe.grouped_paged_ecdp_matmul(
            ta, rs, tpool.buffer, qt, ps, ss, (k, n)))


def test_flash_matmul_grouped_takes_a_paged_slab_and_checks_it():
    """``erdpe.flash_matmul_grouped`` runs a PagedWeight slab (tables
    stacked over slab rows) as the FlashWeight bank of the same bytes;
    the entry refuses what the kernel would, on the CPU too: f32
    activations, unstacked or mismatched tables, a wrong ``row_start``."""
    k, n = 128, 48
    tfws, _, tpool, (qt, ps, ss) = _slab(5, 3, k, n, 1e-3, [0, 1, 2])
    rs = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, k), dtype=np.float32)).to(torch.bfloat16)
    pw = PagedWeight(tpool.buffer, qt, ps, ss, kn=(k, n))
    from repro_torch.core.tiering import FlashWeight
    fw = FlashWeight(*(torch.stack([getattr(t, f) for t in tfws])
                       for f in ("q", "parity", "scale")))
    assert torch.equal(erdpe.flash_matmul_grouped(x, pw, rs),
                       erdpe.flash_matmul_grouped(x, fw, rs))
    args = (tpool.buffer, qt, ps, ss, (k, n))
    with pytest.raises(TypeError):
        tpe.grouped_paged_ecdp_matmul(x.float(), rs, *args)
    with pytest.raises(ValueError):
        tpe.grouped_paged_ecdp_matmul(x, rs, tpool.buffer, qt[0], ps, ss,
                                      (k, n))
    with pytest.raises(ValueError):
        tpe.grouped_paged_ecdp_matmul(x, rs, tpool.buffer, qt, ps[:2], ss,
                                      (k, n))
    with pytest.raises(ValueError):
        tpe.grouped_paged_ecdp_matmul(x, rs[:3], *args)
    with pytest.raises(ValueError):
        tpe.grouped_paged_ecdp_matmul(x, rs.long(), *args)
    with pytest.raises(ValueError):
        tpe.grouped_paged_ecdp_matmul(x, rs, tpool.buffer, qt, ps, ss,
                                      (k + 8, n))


# --- the engine ------------------------------------------------------------------

def test_streamed_emits_the_reference_tokens(jax_streamed):
    """The default StreamConfig (no budget): the JAX streamed engine's
    greedy tokens; only routed experts are fetched; the store's pages were
    read."""
    want, _, _ = jax_streamed
    eng, store = _streamed()
    acquires = _count_acquires(eng)
    assert _run(eng)[0] == want
    st = eng.expert_stats()
    assert st["expert_hit_rate"] > 0
    assert st["expert_hits"] + st["expert_misses"] == acquires[0]
    assert store.pages_read > 0 and store.nand_seconds() > 0
    assert eng.step_traces == -1              # the streamed plane is eager
    eng.close()


def test_streamed_equals_the_resident_engine_bit_for_bit():
    """Under 0.8 of the tier, every step's logits of the slots that ran
    lanes equal the port's resident engine's bit for bit (a slot with no
    lanes samples from a padding lane, whose experts the streamed plane
    leaves unmapped), and so do the tokens."""
    res = _run(Engine(CFG, _params()[1], max_slots=2, max_seq=MAX_SEQ,
                      device="cpu"))
    eng, _ = _streamed(device_budget_bytes=_budget())
    got = _run(eng)
    eng.close()
    assert got[0] == res[0]
    assert len(got[1]) == len(res[1])
    for i, (a, b, live) in enumerate(zip(got[1], res[1], got[2])):
        assert live.any()
        assert torch.equal(a[live], b[live]), i


def test_streamed_under_a_budget_smaller_than_the_tier(jax_streamed):
    """THE acceptance property: a device budget smaller than the MoE flash
    tier serves with the reference's tokens, fetching only routed experts,
    and the expert cache never holds more than its capacity."""
    want, _, _ = jax_streamed
    budget = _budget()
    eng, store = _streamed(device_budget_bytes=budget)
    assert store.total_bytes > budget              # model > device memory
    acquires = _count_acquires(eng)
    seen = []
    out = _run(eng, each_step=lambda e: seen.append(
        (e.expert_cache.bytes_used, e.expert_cache.capacity)))[0]
    assert out == want
    assert all(used <= cap for used, cap in seen)
    st = eng.expert_stats()
    assert st["expert_bytes_fetched"] > 0
    assert st["expert_bytes_per_token"] < st["all_experts_bytes_per_token"]
    assert st["expert_hits"] + st["expert_misses"] == acquires[0]
    assert st["pool_grows"] == 0                   # sized once at init
    eng.close()


def test_counters_equal_the_reference_without_prefetch(jax_streamed):
    """With the prefetch requests off in both engines (the reference's run
    in the module fixture), every expert counter is the JAX engine's:
    hits, misses, bytes, stalls, entries, per-slot hit rates, the largest
    routed set, the slab and the pool reserve."""
    _, want, _ = jax_streamed
    eng, _ = _streamed(device_budget_bytes=_budget())
    _no_prefetch(eng)
    _run(eng)
    got = eng.expert_stats()
    eng.close()
    # the pools' own stats differ by design: the port times its copies
    # (pool_h2d_s) and has no pinned-host fallback (pool_pinned_fallbacks);
    # its staging buffer is allocated at the first upload
    assert set(got) ^ set(want) == {"pool_h2d_s", "pool_pinned_fallbacks"}
    skip = {"misroute_stall_s", "pool_staging_allocs"}
    for key in sorted((set(want) & set(got)) - skip):
        assert got[key] == want[key], key
    assert got["misroute_stalls"] == got["expert_misses"] > 0


def test_pin_all_fetches_nothing(jax_streamed):
    eng, _ = _streamed(pin_all=True)
    assert _run(eng)[0] == jax_streamed[0]
    st = eng.expert_stats()
    assert st["expert_bytes_fetched"] == 0
    assert st["expert_hit_rate"] == 1.0 and st["misroute_stalls"] == 0
    eng.close()


def test_pin_shared_experts(jax_streamed):
    """The first 2 experts of every layer are pinned at init for the whole
    run; the tokens are unchanged."""
    eng, _ = _streamed(pin_shared_experts=2)
    assert _run(eng)[0] == jax_streamed[0]
    for li in range(CFG.n_layers):
        for e in range(2):
            assert (li, e) in eng.expert_cache
            assert eng.expert_cache._entries[(li, e)].pinned
    eng.close()


def test_grouped_routing_matches_resident():
    """Group-limited routing (4 groups, top 2) through both planes: the
    streamed engine's tokens and live logits equal the resident's."""
    gcfg = dataclasses.replace(CFG, n_expert_groups=4, topk_expert_groups=2)
    res = _run(Engine(gcfg, _params()[1], max_slots=2, max_seq=MAX_SEQ,
                      device="cpu"))
    eng, _ = _streamed(gcfg)
    got = _run(eng)
    eng.close()
    assert got[0] == res[0]
    for a, b, live in zip(got[1], res[1], got[2]):
        assert torch.equal(a[live], b[live])


def test_per_slot_stats():
    eng, _ = _streamed()
    _run(eng)
    st = eng.expert_stats()
    assert len(st["slot_hit_rates"]) == 2
    assert all(0.0 <= r <= 1.0 for r in st["slot_hit_rates"])
    assert any(r > 0.0 for r in st["slot_hit_rates"])
    assert 0 < st["max_routed_seen"] <= st["expert_slab"]
    assert st["pool_uploads"] >= 0 and st["pool_pages"] > 0
    eng.close()


def test_auto_expert_budget_returns_dead_slab_rows():
    """The one-shot retune returns the slab's unused rows (e_slab against
    the largest routed set seen) to the cache's capacity, never twice; and
    the flag flips in a real run, which still serves."""
    budget = _budget()
    eng, _ = _streamed(device_budget_bytes=budget, auto_expert_budget=True,
                       auto_depth_after=2)
    cap0 = eng.expert_cache.capacity
    eng._steps_done = 5
    eng._max_routed_seen = 3
    eng.expert_cache.note_stall(0.001)
    eng._maybe_retune_expert_budget()
    assert eng._auto_expert_done
    grown = (eng._e_slab - 3) * eng._max_expert_bytes
    assert eng.expert_cache.capacity == cap0 + grown
    eng._maybe_retune_expert_budget()
    assert eng.expert_cache.capacity == cap0 + grown
    eng.close()
    eng2, _ = _streamed(device_budget_bytes=budget, auto_expert_budget=True,
                        auto_depth_after=2)
    _run(eng2)
    assert eng2.expert_stats()["expert_budget_retuned"]
    if eng2.expert_cache.capacity != cap0:
        assert eng2.expert_cache.capacity > cap0
        assert eng2.expert_cache.bytes_used <= eng2.expert_cache.capacity
    eng2.close()


@pytest.mark.parametrize("kw", [dict(group_size=2),
                                dict(device_budget_bytes=1024)],
                         ids=["group_size", "impossible_budget"])
def test_refusals_carry_the_reference_messages(kw):
    with pytest.raises(ValueError) as want:
        JEngine(jget(ARCH, smoke=True), _params()[0], max_slots=2,
                max_seq=MAX_SEQ, weight_store=JPageStore(n_planes=8),
                stream_cfg=JStreamConfig(**kw))
    with pytest.raises(ValueError) as got:
        _streamed(**kw)
    assert str(got.value) == str(want.value)
    assert ("group_size" if "group_size" in kw else "device_budget") \
        in str(got.value)


def test_close_stops_the_prefetch_worker():
    eng, _ = _streamed()
    _run(eng, prompts=([1, 2, 3],), max_new=2)
    worker = eng.prefetcher._thread
    eng.close()
    assert not worker.is_alive()
    eng.close()                                    # idempotent
    Engine(CFG, _params()[1], max_slots=2, max_seq=MAX_SEQ,
           device="cpu").close()                  # no prefetcher: a no-op


def test_serves_a_jax_die_image(jax_streamed, tmp_path):
    """The JAX-programmed MoE store, saved as a die image and opened
    read-only, serves the reference's tokens with the DRAM tier supplied
    separately."""
    want, _, jstore = jax_streamed
    img = str(tmp_path / "moe.img")
    jstore.save(img)
    eng = Engine(CFG, dram_tier(_params()[1]), max_slots=2, max_seq=MAX_SEQ,
                 weight_store=PageStore.open(img), stream_cfg=StreamConfig(),
                 device="cpu")
    assert eng.store_preprogrammed
    assert _run(eng)[0] == want
    eng.close()


def test_spec_on_the_streamed_moe_plane():
    """Speculative serving composes with expert paging (n-gram, k=2): the
    verify lanes' routed experts enter the slab through the superset lane
    bound, and every step's last-lane logits of the slots that ran lanes,
    and its verify-lane logits within that bound, equal the port's
    resident spec engine's bit for bit,
    as do the tokens and the spec counters (the resident spec engine is
    held against the JAX one on this pair in
    tests/test_torch_moe_engine.py)."""
    kw = dict(max_slots=2, max_seq=MAX_SEQ, kv_aware=False,
              spec_cfg=SpecConfig(k=2), device="cpu")
    lanes, bounds = {}, []

    def keep(name):
        def each(eng):
            lanes.setdefault(name, []).append(eng.last_lane_logits.clone())
            if name == "st":
                # the lanes the routed-expert filter maps (q_lens +
                # draft_cap); past them a lane is padding on both planes
                bounds.append(eng._host_q_lens + eng._host_draft_cap)
        return each
    res_eng = Engine(CFG, _params()[1], **kw)
    res = _run(res_eng, each_step=keep("res"))
    eng = Engine(CFG, _params()[1], weight_store=PageStore(n_planes=8),
                 stream_cfg=StreamConfig(device_budget_bytes=_budget()), **kw)
    got = _run(eng, each_step=keep("st"))
    assert got[0] == res[0]
    for a, b, la, lb, live, bound in zip(got[1], res[1], lanes["st"],
                                         lanes["res"], got[2], bounds):
        assert torch.equal(a[live], b[live])
        for slot, n in enumerate(bound):
            n = min(int(n), la.shape[1])
            assert torch.equal(la[slot, :n], lb[slot, :n])
    assert eng.spec_stats() == res_eng.spec_stats()
    assert eng.spec_stats()["spec_verify_steps"] > 0
    eng.close()


def test_stats_and_obs_samples_expose_the_expert_plane():
    """``stream_stats`` / ``telemetry`` carry the expert counters, the
    scrape carries the expert cache's and the prefetcher's samples, and
    ``/v1/stats`` (``ServeFront.stats``) nests ``experts``."""
    eng, _ = _streamed(device_budget_bytes=_budget())
    front = ServeFront(eng)
    h = front.add_request(PAIR[0], max_new=4)
    assert len(h.result(timeout=120)) == 4
    front.close()
    st = front.stats()
    assert st["experts"]["expert_hits"] + st["experts"]["expert_misses"] > 0
    assert "pages_read" in st["stream"] and "expert_slab" in st["stream"]
    assert eng.telemetry()["expert_fetches"] >= 0
    names = {s.name for s in eng.obs_samples()}
    assert {"expert_cache_hits_total", "expert_bytes_fetched_total",
            "expert_misroute_stall_seconds_total",
            "expert_prefetch_batches_total", "expert_cache_hit_rate",
            "pool_uploads_total", "engine_stall_frac"} <= names
    assert not any(n.startswith("stream_cache") for n in names)
