"""The port's page store, page pool and residency cache against the JAX
package's (``repro.store``), on the same FlashWeights: byte-identical
pages and page tables, JAX die images that open in the port page for page,
the same upload tables from the same free-list discipline, and the same
cache decisions. Weights are made with numpy from a seed and encoded by
the JAX package; the port's copies cross with ``interop``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import tiering as jtier
from repro.models import dense as jdense
from repro.store import PageStore as JPageStore
from repro.store import ResidencyCache as JCache
from repro.store import WeightPagePool as JPool
from repro_torch import interop
from repro_torch.core import tiering as ttier
from repro_torch.store import PageStore, ResidencyCache, StreamConfig
from repro_torch.store import WeightPagePool
from repro_torch.store import nand

SHAPES = [(128, 128), (200, 72), (64, 384), (256, 128)]


def _flash(shape, seed, rber=1e-3):
    """A JAX FlashWeight (leading dims = layer stack) and the port's."""
    w = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jfw = jtier.encode_flash(jnp.asarray(w), rber=rber, seed=seed)
    return jfw, interop.flash_from_numpy(jax.tree.map(np.asarray, jfw),
                                         device="cpu")


def _ref(r):
    return (r.name, tuple(r.shape), r.nbytes, tuple(r.lead))


def _pair(entries, n_planes=4):
    """The same entries programmed into a JAX store and a port store."""
    js, ts = JPageStore(n_planes=n_planes), PageStore(n_planes=n_planes)
    for name, (jfw, tfw) in entries.items():
        if jfw.q.ndim == 2:
            js.put(name, jfw)
            ts.put(name, tfw)
        else:
            assert _ref(js.put_param(name, jfw)) == \
                _ref(ts.put_param(name, tfw))
    return js, ts


def _same_store(js, ts):
    assert ts.n_pages == js.n_pages and ts.total_bytes == js.total_bytes
    np.testing.assert_array_equal(ts._data[:ts.n_pages],
                                  np.asarray(js._data[:js.n_pages]))
    assert {n: {c: comp.to_json() for c, comp in e.items()}
            for n, e in ts.table.items()} == \
        {n: {c: comp.to_json() for c, comp in e.items()}
         for n, e in js.table.items()}


@pytest.fixture(scope="module")
def entries():
    out = {f"w{i}": _flash(s, i) for i, s in enumerate(SHAPES)}
    out["stack"] = _flash((3, 136, 200), 9)         # put_param splits layers
    return out


def test_pages_and_table_equal_the_reference(entries):
    js, ts = _pair(entries)
    _same_store(js, ts)
    assert {f"stack@{i}" for i in range(3)} <= set(ts.table)
    for name in ts.table:
        for c in ("q", "parity", "scale"):
            np.testing.assert_array_equal(ts.get_host(name)[c],
                                          js.get_host(name)[c])
        assert ts.entry_pages(name) == js.entry_pages(name)
        assert ts.entry_nbytes(name) == js.entry_nbytes(name)
    assert {k: _ref(r) for k, r in ts.param_refs().items()} == \
        {k: _ref(r) for k, r in js.param_refs().items()}


def test_plane_interleave_and_read_counters(entries):
    js, ts = _pair(entries, n_planes=4)
    grid = ts.table["w3"]["q"].grid
    for kt in range(grid[0]):
        for nt in range(grid[1]):
            assert ts.page_of("w3", kt, nt) == js.page_of("w3", kt, nt)
    with pytest.raises(IndexError):
        ts.page_of("w3", grid[0], 0)
    pages = ts.table["w0"]["q"].pages                # consecutive pages ...
    assert [ts.plane_of(p)[0] for p in pages] == [p % 4 for p in pages]
    for s in (js, ts):
        s.reset_counters()
        s.get_host("stack@1")
        s.read_pages([0, 4, 8, 1])
    np.testing.assert_array_equal(ts.plane_reads, js.plane_reads)
    assert ts.pages_read == js.pages_read and ts.bytes_read == js.bytes_read
    assert ts.nand_seconds() == pytest.approx(js.nand_seconds())
    assert ts.nand_seconds() == max(ts.plane_reads) * nand.PLANE_READ_S
    st, sj = ts.stats(), js.stats()
    assert {k: st[k] for k in st} == {k: sj[k] for k in st}


def test_jax_die_image_opens_in_the_port(entries, tmp_path):
    js, _ = _pair(entries)
    img = str(tmp_path / "nand.img")
    js.save(img)
    opened = PageStore.open(img)
    assert isinstance(opened._data, np.memmap)
    _same_store(js, opened)
    for name in js.table:
        got, want = opened.get(name, "cpu"), js.get_host(name)
        for c in ("q", "parity", "scale"):
            np.testing.assert_array_equal(getattr(got, c).numpy(), want[c])
    with pytest.raises(ValueError, match="read-only"):
        opened.put("more", entries["w0"][1])
    # and the port's image opens in the JAX package
    _, ts = _pair(entries)
    ts.save(img + "2")
    _same_store(JPageStore.open(img + "2"), ts)


@pytest.fixture(scope="module")
def tiny_params():
    jp = jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def test_deploy_to_store_equals_the_reference(tiny_params):
    """deploy(store=) + the per-layer attn flash copies: the layout the
    streamed engines program, page for page."""
    jp, tp = tiny_params
    js, ts = JPageStore(), PageStore()
    jt, jmap = jtier.deploy(jp, rber=1e-4, seed=3, store=js)
    tt, tmap = ttier.deploy(tp, rber=1e-4, seed=3, store=ts)
    assert tmap == jmap
    jtier.program_attn_flash(js, jp["layers"]["attn"], 4, rber=1e-4, seed=3)
    ttier.program_attn_flash(ts, tp["layers"]["attn"], 4, rber=1e-4, seed=3)
    _same_store(js, ts)
    assert ttier.flash_bytes(tt) == jtier.flash_bytes(jt)
    assert _ref(tt["layers"]["ffn"]["w_up"]) == \
        _ref(jt["layers"]["ffn"]["w_up"])
    # dram_tier is deploy(store=)'s DRAM remainder
    from repro_torch.store import drop_store_refs
    dram = ttier.dram_tier(tp)
    rest = drop_store_refs(tt)

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", v
    assert dict(flat(dram)).keys() == dict(flat(rest)).keys()
    for (_, a), (_, b) in zip(sorted(flat(dram)), sorted(flat(rest))):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# --- the page pool ---------------------------------------------------------

def _pools(js, ts, n_pages):
    return JPool(js, n_pages), WeightPagePool(ts, n_pages, device="cpu")


def test_upload_tables_equal_the_reference(entries):
    js, ts = _pair(entries)
    names = ["w0", "w1", "stack@2"]
    total = sum(ts.entry_pages(n) for n in names)
    jpool, tpool = _pools(js, ts, total + 3)
    for round_ in range(2):                  # again after a free: LIFO reuse
        jt, tt = jpool.upload(names), tpool.upload(names)
        for n in names:
            for k in ("q_tbl", "p_slots", "s_slots", "slots"):
                np.testing.assert_array_equal(tt[n][k], jt[n][k])
            assert tt[n]["kn"] == jt[n]["kn"]
            for tbl_dev, k in zip(tt[n]["dev"], ("q_tbl", "p_slots",
                                                  "s_slots")):
                np.testing.assert_array_equal(tbl_dev.numpy(), tt[n][k])
            assert tt[n]["ready"] is None            # CPU: synchronous
        # the slots hold the store's page bytes verbatim
        ids = np.concatenate([np.asarray(ts.table[n][c].pages)
                              for n in names for c in ("q", "parity",
                                                       "scale")])
        slots = np.concatenate([tt[n]["slots"] for n in names])
        np.testing.assert_array_equal(tpool.buffer[slots].numpy(),
                                      ts.read_pages(ids).view(np.int8))
        assert tpool.used_pages == jpool.used_pages == total
        for n in names[::-1]:
            jpool.free(jt[n]["slots"])
            tpool.free(tt[n]["slots"])
        assert tpool.free_pages == jpool.free_pages == total + 3


def test_one_staged_transfer_per_upload_double_free_and_grow(entries):
    js, ts = _pair(entries)
    jpool, tpool = _pools(js, ts, 4)
    jt, tt = jpool.upload(["w0", "w1"]), tpool.upload(["w0", "w1"])
    st, sj = tpool.stats(), jpool.stats()
    assert st["pool_uploads"] == 1
    for k in ("pool_pages", "pool_free_pages", "pool_used_pages",
              "pool_uploads", "pool_pages_staged", "pool_bytes_staged",
              "pool_grows"):
        assert st[k] == sj[k], k
    assert st["pool_grows"] == 1                     # 4 pages were too few
    kept = tpool.buffer[tt["w0"]["slots"]].clone()
    tpool.upload(["w3"])                             # grows again
    assert tpool.stats()["pool_grows"] == 2 and jpool.upload(["w3"])
    # a grow keeps every live page
    assert torch.equal(tpool.buffer[tt["w0"]["slots"]], kept)
    np.testing.assert_array_equal(tt["w0"]["slots"], jt["w0"]["slots"])
    tpool.free(tt["w0"]["slots"])
    with pytest.raises(ValueError, match="unallocated"):
        tpool.free(tt["w0"]["slots"][:1])


def test_failed_read_returns_the_slots(entries):
    js, ts = _pair(entries)
    pool = WeightPagePool(ts, 64, device="cpu")

    def broken(ids, out=None):
        raise IOError("channel fault")
    ts.read_pages = broken
    with pytest.raises(IOError):
        pool.upload(["w0"])
    assert pool.free_pages == 64 and pool.used_pages == 0


# --- residency cache and stream config -------------------------------------

def test_cache_takes_the_reference_decisions():
    """The same operation sequence through both caches: same answers,
    evictions (by key, in order) and stats."""
    evicted = {"jax": [], "port": []}
    caches = {"jax": JCache(100, on_evict=lambda k, v:
                            evicted["jax"].append(k)),
              "port": ResidencyCache(100, on_evict=lambda k, v:
                                     evicted["port"].append(k))}
    ops = [("insert", "lm", 30, True, False), ("insert", 0, 25, False, True),
           ("insert", 1, 25, False, False), ("acquire", 1),
           ("insert", 2, 25, False, False), ("release", 0),
           ("insert", 3, 40, False, True), ("acquire", 0), ("acquire", 3),
           ("insert", 4, 200, False, False), ("resize", 60),
           ("release", 3), ("release", 3), ("resize", 50),
           ("insert", 5, 20, False, False)]
    answers = {}
    for name, c in caches.items():
        out = []
        for op in ops:
            if op[0] == "insert":
                out.append(c.insert(op[1], f"v{op[1]}", op[2], pin=op[3],
                                    hold=op[4]))
            elif op[0] == "acquire":
                out.append(c.acquire(op[1]))
            elif op[0] == "release":
                out.append(c.release(op[1]))
            else:
                out.append(c.resize(op[1]))
        answers[name] = (out, c.stats(), c.bytes_used, c.pinned_bytes,
                         [k in c for k in ("lm", 0, 1, 2, 3, 4, 5)])
    assert answers["port"] == answers["jax"]
    assert evicted["port"] == evicted["jax"] and evicted["port"]


def test_stream_config_refuses_shards():
    """StreamConfig takes the reference's fields and a shard count (the
    tensor-parallel streamed plane); a store refuses a shard count that
    does not divide its planes."""
    from repro.store import StreamConfig as JStreamConfig
    ported = {f.name for f in dataclasses.fields(StreamConfig)}
    assert ported <= {f.name for f in dataclasses.fields(JStreamConfig)}
    assert StreamConfig().n_shards == 1
    assert StreamConfig(n_shards=2).n_shards == 2
    with pytest.raises(ValueError, match="n_shards"):
        PageStore(n_planes=32, n_shards=3)
