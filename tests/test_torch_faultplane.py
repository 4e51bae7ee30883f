"""The fault plane, port against reference: the host SEC-DED verify
(``core.ecc.check_and_correct_np`` and its batched form), the injector
(``store.faults``), and the PageStore's armed read path (inject -> verify
-> retry -> relocate / degrade) hold the JAX package's bytes and counters
for the same inputs; the ``tests/test_faultplane.py`` scenarios run on the
port's store and engine; and the port's streamed engine, armed, emits the
JAX streamed engine's greedy tokens on OPT_TINY."""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import ecc as jecc
from repro.core import tiering as jtiering
from repro.models import dense as jdense
from repro.serving.engine import Engine as JEngine
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro.store.faults import FaultConfig as JFaultConfig
from repro.store.faults import FaultInjector as JFaultInjector
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.core import ecc
from repro_torch.core import tiering
from repro_torch.serving.engine import Engine
from repro_torch.store import PageStore, StreamConfig, WeightPagePool
from repro_torch.store.faults import FaultConfig, FaultInjector, StoreFault
from repro_torch.store.pagestore import TILE

torch.set_num_threads(2)

MAX_SEQ = 96
# serve_chaos's chaos schedule (benchmarks/serve_chaos.py: CHAOS)
CHAOS = dict(seed=3, read_rber=2e-5, stuck_page_rate=5e-3,
             slow_read_every=9, slow_read_s=0.001, io_error_every=97,
             io_error_burst=1)


def _flip(arr: np.ndarray, n: int, rng) -> np.ndarray:
    out = arr.copy()
    flat = out.reshape(-1)
    pos = rng.choice(flat.size * 8, size=n, replace=False)
    np.bitwise_xor.at(flat, pos // 8, (1 << (pos % 8)).astype(np.uint8))
    return out


def _jfw(seed, k, n, rber=0.0):
    return jtiering.encode_flash(
        jax.random.normal(jax.random.PRNGKey(seed), (k, n), jnp.float32),
        rber=rber, seed=seed)


def _host(fw):
    """A JAX FlashWeight as the port's (torch tensors on the CPU)."""
    return tiering.FlashWeight(
        q=torch.from_numpy(np.array(fw.q)),
        parity=torch.from_numpy(np.array(fw.parity).astype(np.uint8)),
        scale=torch.from_numpy(np.array(fw.scale)))


# --- the host codec ----------------------------------------------------------

@pytest.mark.parametrize("nflips", [0, 1, 2, 7])
def test_check_and_correct_np_matches_reference(nflips):
    """Byte-equal to the reference's numpy and jnp codecs on clean,
    single-bit, double-bit and many-bit reads, flips landing in data and
    parity bytes alike; and on a width that is not a multiple of 8."""
    rng = np.random.default_rng(nflips)
    for k, n in ((64, 48), (40, 13)):
        raw = rng.integers(0, 256, (k, n), dtype=np.uint8)
        parity = np.asarray(jecc.encode(jnp.asarray(raw))).astype(np.uint8)
        both = _flip(np.concatenate([raw.reshape(-1), parity.reshape(-1)]),
                     nflips, rng)
        bad = both[:raw.size].reshape(raw.shape)
        bad_par = both[raw.size:].reshape(parity.shape)
        got = ecc.check_and_correct_np(bad, bad_par)
        for g, want in zip(got, jecc.check_and_correct_np(bad, bad_par)):
            np.testing.assert_array_equal(g, want)
        for g, want in zip(got, jecc.check_and_correct(
                jnp.asarray(bad), jnp.asarray(bad_par))):
            np.testing.assert_array_equal(g, np.asarray(want))
        if nflips == 0:
            assert not got[1].any()
            np.testing.assert_array_equal(got[0], raw)


@pytest.mark.parametrize("nflips", [0, 1, 2, 7])
def test_batched_verify_matches_the_per_page_reference(nflips):
    """The batched form over every tile of an ``encode_flash``ed matrix
    (programmed with rber, so some codewords start dirty) gives each page
    exactly the reference's per-page ``check_and_correct_np``; the in-place
    form the store uses leaves the same bytes and counts."""
    fw = _jfw(11, 3 * TILE, 2 * TILE, rber=2e-5)
    raw = np.asarray(fw.q).view(np.uint8)
    parity = np.asarray(fw.parity).astype(np.uint8)
    grid = (3, 2)
    tiles = raw.reshape(3, TILE, 2, TILE).transpose(0, 2, 1, 3).reshape(
        6, TILE, TILE)
    pars = tiering.page_parities(parity, grid, TILE)
    rng = np.random.default_rng(40 + nflips)
    pages = np.stack([_flip(t, nflips, rng) for t in tiles])
    got_c, got_d, got_u = ecc.check_and_correct_pages(pages, pars)
    inplace = pages.copy()
    dirty, uecc = ecc.correct_pages_(inplace, pars)
    for i in range(6):
        pp = jtiering.tile_parity(parity, i // 2, i % 2, TILE)
        np.testing.assert_array_equal(pars[i], pp)
        np.testing.assert_array_equal(
            tiering.tile_parity(parity, i // 2, i % 2, TILE), pp)
        want = jecc.check_and_correct_np(pages[i], pp)
        np.testing.assert_array_equal(got_c[i], want[0])
        np.testing.assert_array_equal(got_d[i], want[1])
        np.testing.assert_array_equal(got_u[i], want[2])
        np.testing.assert_array_equal(inplace[i], want[0])
        assert dirty[i] == want[1].any()
        assert uecc[i] == want[2].sum()


def test_batched_verify_across_chunks(monkeypatch):
    """A read longer than the verify's chunk (made 4 pages here): every
    page still equals its per-page result."""
    monkeypatch.setattr(ecc, "_CHUNK_BYTES", 4 * TILE * TILE)
    rng = np.random.default_rng(5)
    n = 3 * 4 + 3
    pages = rng.integers(0, 256, (n, TILE, TILE), dtype=np.uint8)
    pars = np.stack([np.asarray(jecc.encode(jnp.asarray(p)))
                     for p in pages]).astype(np.uint8)
    pages = np.stack([_flip(p, i % 5, rng) for i, p in enumerate(pages)])
    c, d, u = ecc.check_and_correct_pages(pages, pars)
    for i in range(n):
        want = jecc.check_and_correct_np(pages[i], pars[i])
        for g, w in zip((c[i], d[i], u[i]), want):
            np.testing.assert_array_equal(g, w)


# --- the injector --------------------------------------------------------------

def test_injector_flips_the_reference_bits():
    """Same config, same (pid, nonce) sequence: the same bytes, stuck
    membership and counters as the reference's injector."""
    cfg = dict(seed=7, read_rber=1e-4, stuck_page_rate=0.3,
               stuck_codewords=4)
    a, b = FaultInjector(FaultConfig(**cfg)), JFaultInjector(
        JFaultConfig(**cfg))
    assert [a.is_stuck(p) for p in range(300)] == \
        [b.is_stuck(p) for p in range(300)]
    rng = np.random.default_rng(0)
    for pid in [3, 5, 3, 8, 5, 5, 120, 7]:
        base = rng.integers(0, 256, TILE * TILE, dtype=np.uint8)
        ra, rb = base.copy(), base.copy()
        a.corrupt_page(pid, ra)
        b.corrupt_page(pid, rb)
        np.testing.assert_array_equal(ra, rb)
    a.mark_good(0)
    b.mark_good(0)
    assert a.is_stuck(0) is False and b.is_stuck(0) is False
    assert a.stats() == b.stats()


def test_injector_pre_read_schedule_matches_the_reference():
    cfg = dict(io_error_every=4, io_error_burst=2, slow_read_every=3,
               slow_read_s=0.0)
    a, b = FaultInjector(FaultConfig(**cfg)), JFaultInjector(
        JFaultConfig(**cfg))
    got = {id(a): [], id(b): []}
    for _ in range(14):
        for inj in (a, b):
            try:
                inj.pre_read(1)
                got[id(inj)].append(0)
            except IOError:
                got[id(inj)].append(1)
    assert got[id(a)] == got[id(b)] == \
        [0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0]
    assert a.stats() == b.stats()
    assert {s.name: s.value for s in a.obs_samples()} == \
        {s.name: s.value for s in b.obs_samples()}


# --- the armed store against the reference store -------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


@pytest.fixture(scope="module")
def stores(jax_params, params):
    """OPT_TINY's flash tier (rber 1e-4 at programming, so some pages
    carry a baseline) programmed by each package's own deploy."""
    js, ts = JPageStore(n_planes=8), PageStore(n_planes=8)
    jtiering.deploy(jax_params, rber=1e-4, seed=0, store=js)
    tiering.deploy(params, rber=1e-4, seed=0, store=ts)
    np.testing.assert_array_equal(ts._data[:ts.n_pages],
                                  np.asarray(js._data[:js.n_pages]))
    return js, ts


def _stats_equal(js, ts):
    sj, st = js.stats(), ts.stats()
    for k, v in sj.items():
        assert st[k] == v, (k, st[k], v)
    return sj


def _read_sequence(js, ts, seed, n_reads=12, staged=False):
    """The same random reads (whole entries, then random page sets) from
    both stores; the port's into a staging buffer when ``staged``."""
    rng = np.random.default_rng(seed)
    for name in sorted(js.table):
        got = ts.get_host(name)
        for c, want in js.get_host(name).items():
            np.testing.assert_array_equal(got[c], want)
    for _ in range(n_reads):
        ids = rng.choice(js.n_pages, size=int(rng.integers(1, js.n_pages)),
                         replace=False)
        want = js.read_pages(ids)
        if staged:
            out = np.empty((ids.size, ts.page_bytes), np.uint8)
            got = ts.read_pages(ids, out=out)
            assert got is out
        else:
            got = ts.read_pages(ids)
        np.testing.assert_array_equal(got, want)
    for name in js.table:
        assert ts.table[name]["q"].pages == list(js.table[name]["q"].pages)


def test_armed_writable_store_matches_the_reference(stores):
    """Both stores armed alike, the same reads: equal bytes, equal page
    tables after relocation (the same new page ids), equal counters."""
    js, ts = stores
    cfg = dict(seed=3, read_rber=2e-4, stuck_page_rate=0.02,
               slow_read_every=5, slow_read_s=0.0)
    js.attach_injector(JFaultInjector(JFaultConfig(**cfg)))
    ts.attach_injector(FaultInjector(FaultConfig(**cfg)))
    try:
        _read_sequence(js, ts, seed=1)
        s = _stats_equal(js, ts)
        assert s["relocations"] > 0 and s["retry_corrected"] > 0
        assert s["ecc_corrected_pages"] > 0 and s["degraded_pages"] == 0
        assert ts.n_pages == js.n_pages
        np.testing.assert_array_equal(ts._data[:ts.n_pages],
                                      np.asarray(js._data[:js.n_pages]))
        assert ts.pages_verified > 0 and ts.verify_s > 0
    finally:
        js.injector = None
        ts.attach_injector(None)


def test_armed_die_image_matches_the_reference(stores, tmp_path):
    """A read-only die image cannot relocate: both degrade the same pages
    and serve the same (DRAM-tier) bytes."""
    js, _ = stores
    js.save(str(tmp_path / "die"))
    jo = JPageStore.open(str(tmp_path / "die"))
    to = PageStore.open(str(tmp_path / "die"))
    cfg = dict(seed=5, read_rber=1e-4, stuck_page_rate=0.05)
    jo.attach_injector(JFaultInjector(JFaultConfig(**cfg)))
    to.attach_injector(FaultInjector(FaultConfig(**cfg)))
    _read_sequence(jo, to, seed=2, n_reads=8, staged=True)
    s = _stats_equal(jo, to)
    assert s["relocations"] == 0
    assert s["degraded_pages"] > 0 and s["dram_fallback_reads"] > 0
    assert to.degraded_pages == jo.degraded_pages


def test_a_read_naming_a_page_twice_runs_page_at_a_time():
    """Duplicate ids advance the injector's nonce twice, as the
    reference's page-at-a-time loop does."""
    js, ts = JPageStore(n_planes=4), PageStore(n_planes=4)
    fw = _jfw(3, TILE, 2 * TILE)
    js.put("w", fw)
    ts.put("w", _host(fw))
    cfg = dict(seed=1, read_rber=3e-4, stuck_page_rate=0.3)
    js.attach_injector(JFaultInjector(JFaultConfig(**cfg)))
    ts.attach_injector(FaultInjector(FaultConfig(**cfg)))
    ids = [0, 1, 0, 0, 1]
    np.testing.assert_array_equal(ts.read_pages(ids), js.read_pages(ids))
    _stats_equal(js, ts)


# --- tests/test_faultplane.py's scenarios on the port --------------------------

def _store(seed, k=2 * TILE, n=2 * TILE):
    store = PageStore(n_planes=4)
    store.put("w", _host(_jfw(seed, k, n)))
    return store


def test_corrected_reads_are_bit_identical_to_fault_free():
    store = _store(2)
    clean = store.get_host("w")["q"]
    store.attach_injector(FaultInjector(FaultConfig(seed=1, read_rber=3e-5)))
    for _ in range(6):
        np.testing.assert_array_equal(store.get_host("w")["q"], clean)
    s = store.stats()
    assert s["ecc_corrected_pages"] > 0 and s["fault_transient_flips"] > 0
    assert s["relocations"] == 0 and s["uecc_detected"] == 0


def test_stuck_page_relocates_on_writable_store():
    store = _store(3)
    before = list(store.table["w"]["q"].pages)
    clean = store.get_host("w")["q"]
    store.attach_injector(FaultInjector(FaultConfig(seed=5,
                                                    stuck_page_rate=0.5)))
    np.testing.assert_array_equal(store.get_host("w")["q"], clean)
    s = store.stats()
    assert s["uecc_detected"] >= 1
    assert s["read_retries"] >= store.max_read_retries
    assert s["relocations"] >= 1 and s["degraded_pages"] == 0
    assert list(store.table["w"]["q"].pages) != before
    assert sum(s["plane_relocations"]) == s["relocations"]
    n = s["relocations"]
    np.testing.assert_array_equal(store.get_host("w")["q"], clean)
    assert store.stats()["relocations"] == n


def test_stuck_page_degrades_on_readonly_die_image(tmp_path):
    _store(4).save(str(tmp_path / "die"))
    store = PageStore.open(str(tmp_path / "die"))
    clean = store.get_host("w")["q"]
    store.attach_injector(FaultInjector(FaultConfig(seed=5,
                                                    stuck_page_rate=0.5)))
    np.testing.assert_array_equal(store.get_host("w")["q"], clean)
    s = store.stats()
    assert s["relocations"] == 0 and s["degraded_pages"] >= 1
    np.testing.assert_array_equal(store.get_host("w")["q"], clean)
    assert store.stats()["dram_fallback_reads"] > s["dram_fallback_reads"]


def test_program_time_rber_baseline_not_retried():
    store = _store(5)
    corrupted, nflip = ecc.inject_bit_errors_np(
        store._data[:store.n_pages], 5e-5, seed=11)
    store._data[:store.n_pages] = corrupted
    assert nflip > 0
    store.attach_injector(FaultInjector(FaultConfig(seed=0)))
    a, b = store.get_host("w")["q"], store.get_host("w")["q"]
    np.testing.assert_array_equal(a, b)
    s = store.stats()
    assert s["uecc_detected"] == 0
    assert s["read_retries"] == 0 and s["relocations"] == 0


def test_injected_io_error_does_not_leak_pool_slots():
    store = _store(6, TILE, TILE)
    pool = WeightPagePool(store, n_pages=16, device="cpu")
    free0 = pool.free_pages
    store.attach_injector(
        FaultInjector(FaultConfig(io_error_every=1, io_error_burst=1)))
    with pytest.raises(IOError):
        pool.upload(["w"])
    assert pool.free_pages == free0
    store.attach_injector(None)
    assert "w" in pool.upload(["w"]) and pool.free_pages < free0


def test_storefault_is_a_typed_runtime_error():
    assert issubclass(StoreFault, RuntimeError)
    assert isinstance(StoreFault("boom"), Exception)


def test_disarmed_reads_keep_the_fast_path():
    """Disarmed, nothing of the fault plane runs: no verify, no counters,
    the staging buffer is filled in place."""
    store = _store(7)
    ids = np.arange(store.n_pages)
    out = np.empty((ids.size, store.page_bytes), np.uint8)
    assert store.read_pages(ids, out=out) is out
    np.testing.assert_array_equal(out, store._data[:store.n_pages])
    assert store.pages_verified == 0
    assert "fault_calls" not in store.stats()


# --- the streamed engine under faults -----------------------------------------

def _serve(eng):
    r1 = eng.submit(list(range(1, 30)), max_new=8)
    r2 = eng.submit([9, 8], max_new=8)
    out = eng.run()
    return [out[r1], out[r2]]


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    eng = JEngine(J_OPT_TINY, jax_params, max_slots=2, max_seq=MAX_SEQ,
                  weight_store=JPageStore(n_planes=8),
                  stream_cfg=JStreamConfig(group_size=1))
    return _serve(eng)


def _armed_engine(params, **fault_kw):
    store = PageStore(n_planes=8)
    probe = PageStore()
    Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
           weight_store=probe, stream_cfg=StreamConfig(pin_edges=False),
           device="cpu")
    # 0.6 of the tier: windows evict and re-read every step, so the
    # armed store sees reads all run long
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                 weight_store=store, device="cpu",
                 stream_cfg=StreamConfig(
                     group_size=1, prefetch_depth=2,
                     device_budget_bytes=int(probe.total_bytes * 0.6)))
    store.attach_injector(FaultInjector(FaultConfig(**fault_kw)))
    return eng, store


def test_armed_streamed_engine_emits_the_reference_tokens(params,
                                                         jax_tokens):
    eng, store = _armed_engine(params, **{**CHAOS, "stuck_page_rate": 0.2})
    assert _serve(eng) == jax_tokens
    s = eng.stream_stats()
    assert s["ecc_corrected_pages"] > 0 and s["uecc_detected"] > 0
    assert s["read_retries"] > 0 and s["relocations"] > 0
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident


def test_streamed_step_frees_its_windows_when_compute_raises(params,
                                                             jax_tokens,
                                                             monkeypatch):
    """A group whose compute raises mid-stream: the step closes the
    stream at once (the held window's slots back, the worker stopped), and
    re-running the step serves the reference's tokens."""
    from repro_torch.serving import engine as eng_mod

    eng, store = _armed_engine(params, seed=2, read_rber=2e-5)
    real = eng_mod._stream_group_impl
    calls = {"n": None}

    def flaky(*a, **k):
        if calls["n"] is not None:
            calls["n"] += 1
            if calls["n"] == 2:           # the second group of a step
                raise RuntimeError("injected group fault")
        return real(*a, **k)

    monkeypatch.setattr(eng_mod, "_stream_group_impl", flaky)
    r1 = eng.submit(list(range(1, 30)), max_new=8)
    r2 = eng.submit([9, 8], max_new=8)
    assert eng.step() > 0
    threads0 = threading.active_count()
    calls["n"] = 0
    # the raised exception kept alive (its traceback holds the step's
    # frame), as a fault handler holding it does
    with pytest.raises(RuntimeError, match="injected group fault") as err:
        eng.step()
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident     # nothing held past the raise
    assert all(e.refs == 0 for e in eng.cache._entries.values())
    assert threading.active_count() == threads0  # the worker has stopped
    assert err.value is not None
    out = eng.run()
    assert [out[r1], out[r2]] == jax_tokens
