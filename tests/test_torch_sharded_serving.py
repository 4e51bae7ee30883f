"""Tensor-parallel streamed serving of the dense plane on the port
(``launch/mesh``, ``launch/sharding.tp_shard_axis``, ``PageStore.
shard_entry`` / ``shard_host_slices``, ``ShardedWeightPagePool``, the
row-parallel FFN and ``StreamConfig(n_shards=S)``) against the JAX package,
on the CPU, over meshes of one CPU device repeated (``[cpu] * S``).

The JAX side runs on its single CPU device wherever no mesh is needed: its
partitioner, its store's plans and host slices, its paged ECDP on each
shard's local tables, and its unsharded streamed engine, whose greedy
tokens the sharded port must emit. Its sharded engine runs once, in a
subprocess with 4 forced virtual devices (``reference_dump``), for its
tokens and pool counters. Inputs are numpy draws from fixed seeds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyp_compat import given, settings, st
from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import tiering as jtier
from repro.kernels import ops as jops
from repro.kernels.paged_ffn import paged_ecdp_matmul_xla
from repro.launch.sharding import tp_shard_axis as j_tp_shard_axis
from repro.models import dense as jdense
from repro.serving.engine import Engine as JEngine
from repro.serving.sampler import SampleConfig as JSample
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro.store.pagestore import shard_tiles as j_shard_tiles
from repro_torch import interop
from repro_torch.configs import ARCHS, OPT_TINY, get_config
from repro_torch.core.tiering import ATTN_FLASH_KEYS, deploy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.sharding import tp_shard_axis
from repro_torch.models import family_module
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleConfig
from repro_torch.store import PageStore, ShardedWeightPagePool, StreamConfig
from repro_torch.store.pagestore import shard_tiles

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 96
# tests/test_sharded_serving.py's engine workload
PROMPTS = ([*range(1, 30)], [9, 8])
TP_ATOL, TP_RTOL = 1e-3, 1e-5      # the reference's psum bound


def _flash(shape, seed, rber=1e-3):
    """A JAX FlashWeight from a numpy draw, and the port's copy."""
    w = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jfw = jtier.encode_flash(jnp.asarray(w), rber=rber, seed=seed)
    return jfw, interop.flash_from_numpy(jax.tree.map(np.asarray, jfw),
                                         device="cpu")


def _stores(named: dict, n_planes=8):
    """The same entries programmed into a JAX store and a port store."""
    js, ts = JPageStore(n_planes=n_planes), PageStore(n_planes=n_planes)
    for name, (jfw, tfw) in named.items():
        js.put(name, jfw)
        ts.put(name, tfw)
    return js, ts


def _same_plan(tp, jp):
    assert (tp.axis, tp.n_shards, tuple(tp.kn), tuple(tp.local_kn),
            tuple(tp.local_grid), tp.parity_nbytes, tp.scale_nbytes) == \
        (jp.axis, jp.n_shards, tuple(jp.kn), tuple(jp.local_kn),
         tuple(jp.local_grid), jp.parity_nbytes, jp.scale_nbytes)
    assert tp.local_payload_bytes == jp.local_payload_bytes
    assert len(tp.q_pages) == len(jp.q_pages)
    for a, b in zip(tp.q_pages, jp.q_pages):
        np.testing.assert_array_equal(a, np.asarray(b))


def _real_nbytes(comp) -> int:
    """A JAX store component's payload bytes, from its shape and dtype."""
    return int(np.prod(comp.shape)) * np.dtype(comp.dtype).itemsize


# --- the partitioner ---------------------------------------------------------


@settings(max_examples=50, deadline=None)
@given(kt=st.integers(1, 8), nt=st.integers(1, 8),
       s=st.sampled_from([1, 2, 4]), axis=st.sampled_from([0, 1]))
def test_shard_tiles_exact_cover(kt, nt, s, axis):
    """Every tile lands in exactly one shard, the loads are equal, and the
    partition is the reference's."""
    grid = (kt * s, nt) if axis == 0 else (kt, nt * s)
    parts, local = shard_tiles(grid, s, axis)
    jparts, jlocal = j_shard_tiles(grid, s, axis)
    assert local == jlocal
    assert len(parts) == len(jparts) == s
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(parts).tolist()) == \
        list(range(grid[0] * grid[1]))
    assert all(len(p) == len(parts[0]) for p in parts)
    assert local == ((grid[0] // s, grid[1]) if axis == 0
                     else (grid[0], grid[1] // s))


@pytest.mark.parametrize("grid,s,axis,match", [
    ((3, 4), 2, 0, "divisible"), ((4, 3), 2, 1, "divisible"),
    ((4, 4), 2, 2, "axis")])
def test_shard_tiles_rejects_uneven(grid, s, axis, match):
    for fn in (shard_tiles, j_shard_tiles):
        with pytest.raises(ValueError, match=match):
            fn(grid, s, axis)


# --- store entries -----------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(kt=st.integers(1, 3), nt=st.integers(1, 3),
       s=st.sampled_from([2, 4]), axis=st.sampled_from([0, 1]),
       seed=st.integers(0, 2**31 - 1))
def test_shard_entry_equals_the_reference(kt, nt, s, axis, seed):
    """On the same encoded entry the port's plan is the JAX store's: the
    per-shard q pages (an exact disjoint cover), local (K, N) and grid,
    and the parity / scale byte counts, which split with their tiles
    (checked against the component's real byte count). The host slices
    are byte-equal and reassemble the whole parity run."""
    shape = (kt * 128 * (s if axis == 0 else 1),
             nt * 128 * (s if axis == 1 else 1))
    js, ts = _stores({"w": _flash(shape, seed % 1000)})
    tp, jp = ts.shard_entry("w", s, axis), js.shard_entry("w", s, axis)
    _same_plan(tp, jp)
    assert tp.axis == axis
    comp = js.table["w"]
    assert sorted(np.concatenate(tp.q_pages).tolist()) == \
        sorted(comp["q"].pages)
    assert tp.parity_nbytes * s == _real_nbytes(comp["parity"]) == \
        ts.table["w"]["parity"].nbytes
    scale_nb = _real_nbytes(comp["scale"])
    assert tp.scale_nbytes == (scale_nb // s if axis == 1 else scale_nb)
    slices, jslices = ts.shard_host_slices("w", tp), \
        js.shard_host_slices("w", jp)
    for (p, sc), (jpar, jsc) in zip(slices, jslices):
        assert p.tobytes() == np.asarray(jpar).tobytes()
        assert sc.tobytes() == np.asarray(jsc).tobytes()
        assert p.nbytes == tp.parity_nbytes and sc.nbytes == tp.scale_nbytes
    k, n = shape
    full = ts._get_flat(ts.table["w"]["parity"])
    if axis == 1:      # tile column c is local column c // s on shard c % s
        cols = [slices[c % s][0].reshape(k // 8, n // s)
                [:, (c // s) * 128:(c // s + 1) * 128]
                for c in range(n // 128)]
        np.testing.assert_array_equal(np.concatenate(cols, axis=1), full)
    else:              # tile row r: 16 parity rows, on shard r % s
        rows = [slices[r % s][0][(r // s) * 16:(r // s + 1) * 16]
                for r in range(k // 128)]
        np.testing.assert_array_equal(np.concatenate(rows, axis=0), full)


@pytest.mark.parametrize("shape,s,axis", [
    ((128, 192), 4, 1),        # 192 is no whole number of tiles
    ((384, 128), 2, 0),        # 3 tile rows over 2 shards
    ((256, 256), 4, None)])    # replicated by the rule (attn copies)
def test_shard_entry_fallback_replicates(shape, s, axis):
    """An axis that does not split into whole tiles replicates the entry:
    every shard stages it whole, as in the reference."""
    js, ts = _stores({"w": _flash(shape, 3, rber=0.0)})
    tp, jp = ts.shard_entry("w", s, axis), js.shard_entry("w", s, axis)
    _same_plan(tp, jp)
    assert tp.axis is None and tp.local_kn == shape
    for p in tp.q_pages:
        assert sorted(p.tolist()) == sorted(ts.table["w"]["q"].pages)
    for (p, sc), (jpar, jsc) in zip(ts.shard_host_slices("w", tp),
                                    js.shard_host_slices("w", jp)):
        assert p.tobytes() == np.asarray(jpar).tobytes()
        assert sc.tobytes() == np.asarray(jsc).tobytes()


# --- die images --------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(s=st.sampled_from([1, 2, 4]))
def test_save_open_roundtrip_preserves_partition(s, tmp_path_factory):
    """The partition survives save / open, and a JAX-saved image opened in
    the port hands back the JAX store's plan and page bytes."""
    d = tmp_path_factory.mktemp("img")
    js, ts = _stores({"w": _flash((128, 512), s)})
    plan = ts.shard_entry("w", s, 1)
    ts.save(str(d / "port.img"), n_shards=s)
    js.save(str(d / "jax.img"), n_shards=s)
    for img in ("port.img", "jax.img"):
        re = PageStore.open(str(d / img), n_shards=s)
        _same_plan(re.shard_entry("w", s, 1), plan)
        ids = np.concatenate(plan.q_pages)
        np.testing.assert_array_equal(re.read_pages(ids),
                                      ts.read_pages(ids))
    _same_plan(plan, js.shard_entry("w", s, 1))


def test_open_rejects_shard_mismatch(tmp_path):
    path = str(tmp_path / "die.img")
    _, ts = _stores({"w": _flash((128, 128), 0, rber=0.0)})
    ts.save(path, n_shards=2)
    with pytest.raises(ValueError, match="n_shards=2.*n_shards=4"):
        PageStore.open(path, n_shards=4)
    ts.save(path, n_shards=1)       # an unsharded image serves any mesh
    assert PageStore.open(path, n_shards=4).n_shards == 4


# --- tp_shard_axis -----------------------------------------------------------


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_shard_axis_equals_the_reference(arch):
    """On every entry name of the arch's smoke deploy (the store's table,
    with the dense family's attention copies) and every param path, the
    port's axis is the reference's."""
    cfg = get_config(arch, smoke=True)
    params = family_module(cfg.family).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    store = PageStore()
    deploy(params, store=store)
    names = list(store.table) + list(_leaf_paths(params))
    if cfg.family == "dense":
        names += [f"attn_flash/{k}@{li}" for k in ATTN_FLASH_KEYS
                  for li in range(cfg.n_layers)]
    assert len(store.table) > 0
    got = {n: tp_shard_axis(n) for n in names}
    assert got == {n: j_tp_shard_axis(n) for n in names}
    if cfg.family == "dense":
        assert {got[f"layers/ffn/{k}@0"] for k in ("w_up", "w_down")} \
            == {0, 1}


def test_mesh():
    """A mesh of distinct devices needs that many; an explicit list may
    repeat one."""
    with pytest.raises(ValueError, match="distinct cpu devices"):
        tmesh.make_model_mesh(2, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="distinct cuda devices"):
            tmesh.make_model_mesh(2, "cuda")
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_model_mesh(0, "cpu")
    with pytest.raises(ValueError, match="needs 3 devices"):
        tmesh.make_model_mesh(3, devices=["cpu"] * 2)
    m = tmesh.make_model_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == (tmesh.MODEL_AXIS,) and m.n_shards == 4
    assert m.first == torch.device("cpu")
    assert tmesh.data_axis_names(m) == ()
    assert tmesh.make_model_mesh(1, "cpu").devices == (torch.device("cpu"),)


# --- the per-shard paged FFN -------------------------------------------------


def _jax_local_pool(js, name, plan, s):
    """Shard ``s``'s partition of one entry built from the JAX store's
    plan and host slices, and its local tables (the unsharded format)."""
    pb = js.page_bytes
    q = np.asarray(js.read_pages(plan.q_pages[s]))
    par, sc = js.shard_host_slices(name, plan)[s]
    runs = []
    for arr in (par, sc):
        raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
        pad = np.zeros((-(-raw.size // pb)) * pb, np.uint8)
        pad[:raw.size] = raw
        runs.append(pad.reshape(-1, pb))
    pool = np.concatenate([q] + runs).view(np.int8)
    nq, npar = len(q), len(runs[0])
    tbl = (np.arange(nq, dtype=np.int32).reshape(plan.local_grid),
           np.arange(nq, nq + npar, dtype=np.int32),
           np.arange(nq + npar, len(pool), dtype=np.int32))
    return jnp.asarray(pool), [jnp.asarray(t) for t in tbl]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_per_shard_partials_match_the_reference(n_shards, rber):
    """The column-parallel gate then the row-parallel down over the sharded
    pool: each shard's partials are bit-equal to ``paged_ecdp_matmul_xla``
    on the JAX ``ShardPlan``'s local tables, and their f32 sum
    (``all_reduce_sum``) is within the reference's psum bound of the JAX
    unsharded ECDP chain."""
    from repro_torch.core.erdpe import all_reduce_sum
    from repro_torch.kernels.paged_ecdp import paged_ecdp_matmul
    k, dff = 128, 512
    gate, down = _flash((k, dff), 0, rber), _flash((dff, k), 1, rber)
    js, ts = _stores({"gate": gate, "down": down})
    mesh = tmesh.make_model_mesh(n_shards, devices=["cpu"] * n_shards)
    axis_of = {"gate": 1, "down": 0}.get
    pool = ShardedWeightPagePool(
        ts, (ts.entry_pages("gate") + ts.entry_pages("down")) // n_shards,
        mesh, axis_of=axis_of)
    tbls = pool.upload(["gate", "down"])
    x = np.random.default_rng(2).standard_normal((4, k), dtype=np.float32)
    partials = []
    for s in range(n_shards):
        def paged(name, a):
            t = tbls[name]
            return paged_ecdp_matmul(a, pool.buffer[s], *t["dev_shards"][s],
                                     t["kn"])
        y = paged("gate", torch.from_numpy(x))
        part = paged("down", y)
        jbufs = {n: _jax_local_pool(js, n, js.shard_entry(n, n_shards,
                                                         axis_of(n)), s)
                 for n in ("gate", "down")}
        jy = paged_ecdp_matmul_xla(jnp.asarray(x), jbufs["gate"][0],
                                   *jbufs["gate"][1], tbls["gate"]["kn"])
        jpart = paged_ecdp_matmul_xla(jy, jbufs["down"][0],
                                      *jbufs["down"][1], tbls["down"]["kn"])
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))
        partials.append(part)
    out = all_reduce_sum(partials, mesh)
    want = jops.ecdp_matmul_xla(
        jops.ecdp_matmul_xla(jnp.asarray(x), gate[0].q, gate[0].parity,
                             gate[0].scale, ecc_enabled=True),
        down[0].q, down[0].parity, down[0].scale, ecc_enabled=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TP_RTOL,
                               atol=TP_ATOL)
    assert pool.stats()["pool_shard_transfers"] == n_shards


# --- the sharded pool --------------------------------------------------------


def test_sharded_pool_tables_transfers_and_lockstep_grow():
    """Shard-local tables in the unsharded format (the local grid and kn),
    each partition holding its shard's store pages and host slices; one
    transfer per shard per upload; a grow keeps every shard's live pages
    and the slots symmetric."""
    S = 2
    named = {"up": _flash((256, 512), 4), "down": _flash((512, 256), 5),
             "attn": _flash((256, 256), 6)}
    js, ts = _stores(named)
    mesh = tmesh.make_model_mesh(S, devices=["cpu"] * S)
    axis_of = {"up": 1, "down": 0, "attn": None}.get
    pool = ShardedWeightPagePool(ts, 8, mesh, axis_of=axis_of)
    tbls = pool.upload(["up", "down"])
    assert pool.stats()["pool_grows"] == 1 and pool.n_pages >= 16
    st1 = pool.stats()
    for name in ("up", "down"):
        plan, t = pool.plan(name), tbls[name]
        _same_plan(plan, js.shard_entry(name, S, axis_of(name)))
        assert t["q_tbl"].shape == plan.local_grid
        assert t["kn"] == plan.local_kn
        assert len(t["p_slots"]) == -(-plan.parity_nbytes // 16384)
        assert len(t["s_slots"]) == -(-plan.scale_nbytes // 16384)
        slices = ts.shard_host_slices(name, plan)
        for s in range(S):
            part = pool.buffer[s].numpy().view(np.uint8)
            assert all(torch.equal(a, b) for a, b in zip(t["dev_shards"][s],
                                                          t["dev"]))
            np.testing.assert_array_equal(
                part[t["q_tbl"].reshape(-1)],
                ts.read_pages(plan.q_pages[s]))
            for run, arr in zip((t["p_slots"], t["s_slots"]), slices[s]):
                raw = part[run].reshape(-1)[:arr.nbytes]
                assert raw.tobytes() == arr.tobytes()
    kept = [b[tbls["up"]["slots"]].clone() for b in pool.buffer]
    more = pool.upload(["attn"] * 1)                # replicated: whole entry
    assert more["attn"]["kn"] == (256, 256)
    st2 = pool.stats()
    assert st2["pool_grows"] == 2 and st2["pool_uploads"] == 2
    assert st2["pool_shard_transfers"] == S * st2["pool_uploads"]
    assert st2["pool_shards"] == S
    assert st2["pool_local_pages"] == st2["pool_pages"] == pool.n_pages
    assert st2["pool_pages_staged"] - st1["pool_pages_staged"] == \
        S * ts.entry_pages("attn")
    assert all(b.shape == (pool.n_pages, 16384) for b in pool.buffer)
    for b, k in zip(pool.buffer, kept):
        assert torch.equal(b[tbls["up"]["slots"]], k)
    used = pool.used_pages
    pool.free(tbls["up"]["slots"])
    assert pool.used_pages == used - len(tbls["up"]["slots"])
    with pytest.raises(ValueError, match="unallocated"):
        pool.free(tbls["up"]["slots"][:1])
    names = {s.name for s in pool.obs_samples()}
    assert {"pool_shards", "pool_shard_transfers_total"} <= names


# --- the engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def _serve(eng):
    rids = [eng.submit(list(p), max_new=8) for p in PROMPTS]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    """The JAX streamed engine's greedy tokens (one device, unsharded)."""
    eng = JEngine(J_OPT_TINY, jax_params, max_slots=2, max_seq=MAX_SEQ,
                  rber=0.0, weight_store=JPageStore(n_planes=8),
                  stream_cfg=JStreamConfig())
    return _serve(eng)


def _sharded(params, n_shards, **stream_kw):
    return Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                  weight_store=PageStore(n_planes=8),
                  stream_cfg=StreamConfig(n_shards=n_shards, **stream_kw),
                  device="cpu", mesh=["cpu"] * n_shards)


@pytest.fixture(scope="module")
def tier_bytes(params):
    probe = PageStore(n_planes=8)
    Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
           weight_store=probe, stream_cfg=StreamConfig(pin_edges=False),
           device="cpu").close()
    return probe.total_bytes


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("budget", [None, 0.7])
def test_sharded_engine_emits_the_reference_tokens(params, jax_tokens,
                                                   tier_bytes, n_shards,
                                                   budget):
    """OPT_TINY streamed over [cpu] * S emits the JAX streamed engine's
    greedy tokens — also under a device budget smaller than the tier, where
    it really streams — with one staged transfer per shard per upload,
    each shard's partition on its device, and no leaked slot."""
    kw = {}
    if budget is not None:
        kw = dict(prefetch_depth=1, device_budget_bytes=int(tier_bytes
                                                            * budget))
    eng = _sharded(params, n_shards, **kw)
    assert isinstance(eng.wpool, ShardedWeightPagePool)
    assert eng._win_shapes["ffn"] == {"w_up": (128, 512 // n_shards),
                                      "w_down": (512 // n_shards, 128)}
    assert _serve(eng) == jax_tokens
    st = eng.stream_stats()
    assert st["pool_shards"] == n_shards
    assert st["pool_shard_transfers"] == n_shards * st["pool_uploads"]
    assert all(b.device == d for b, d in zip(eng.wpool.buffer,
                                             eng.mesh.devices))
    if budget is not None:
        assert eng.store.total_bytes > kw["device_budget_bytes"]
        assert st["bytes_streamed"] > 0
        assert st["pool_uploads"] == st["groups_streamed"] > 0
        assert st["pool_grows"] == 0
    resident = sum(eng._entry_pages_local(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident
    eng.close()


REF_KEYS = ("pool_shards", "pool_shard_transfers", "pool_uploads",
            "pool_local_pages", "pool_pages")

_REF_DUMP = f"""
import json
import jax
from repro.configs.paper_models import OPT_TINY
from repro.models import dense
from repro.serving.engine import Engine
from repro.store import PageStore, StreamConfig
assert len(jax.devices()) == 4, jax.devices()
params = dense.init(OPT_TINY, jax.random.PRNGKey(0))
eng = Engine(OPT_TINY, params, max_slots=2, max_seq={MAX_SEQ}, rber=0.0,
             weight_store=PageStore(n_planes=8),
             stream_cfg=StreamConfig(n_shards=4))
rids = [eng.submit(list(p), max_new=8) for p in {PROMPTS!r}]
toks = eng.run()
st = eng.stream_stats()
print(json.dumps(dict(tokens=[toks[r] for r in rids],
                      **{{k: st[k] for k in {REF_KEYS!r}}})))
"""


@pytest.fixture(scope="module")
def reference_dump():
    """The reference's sharded dense engine (S=4, 4 virtual CPU devices),
    run once in a subprocess: its tokens and pool counters."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REF_DUMP], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_engine_matches_the_reference_dump(params, reference_dump,
                                                   jax_tokens):
    """At S=4 the port's tokens and pool counters (shards, transfers,
    uploads, local pages, pages) are the reference's sharded engine's."""
    eng = _sharded(params, 4)
    assert _serve(eng) == reference_dump["tokens"] == jax_tokens
    st = eng.stream_stats()
    assert {k: st[k] for k in REF_KEYS} == \
        {k: reference_dump[k] for k in REF_KEYS}
    eng.close()


def test_sharded_engine_refusals(params):
    """No fallback hides a shard: an FFN the shards cannot split whole is
    refused (a dense one, and a MoE expert bank: the reference's
    ``test_sharded_rejects_unshardable_ffn``), so are a shard count with no
    store, a mesh of another size, one whose first device is not the
    engine's, and a mesh of distinct devices the host lacks."""
    cfg = get_config("llama3-405b", smoke=True)            # d_ff 256
    lp = family_module("dense").init(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    with pytest.raises(ValueError, match="cannot partition"):
        Engine(cfg, lp, max_slots=2, max_seq=MAX_SEQ,
               weight_store=PageStore(n_planes=8),
               stream_cfg=StreamConfig(n_shards=4), device="cpu",
               mesh=["cpu"] * 4)
    mcfg = get_config("qwen3-moe-30b-a3b", smoke=True)     # d_ff 32
    mp = family_module("moe").init(mcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    with pytest.raises(ValueError, match="cannot partition"):
        Engine(mcfg, mp, max_slots=2, max_seq=MAX_SEQ,
               weight_store=PageStore(n_planes=8),
               stream_cfg=StreamConfig(n_shards=4), device="cpu",
               mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="weight_store"):
        Engine(OPT_TINY, params, stream_cfg=StreamConfig(n_shards=2),
               device="cpu")

    def engine(mesh):
        return Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                      weight_store=PageStore(n_planes=8),
                      stream_cfg=StreamConfig(n_shards=2), device="cpu",
                      mesh=mesh)
    for mesh, match in ((["cpu"] * 3, "a mesh of 3"),
                        (None, "distinct cpu devices"),
                        (["meta", "cpu"], "first device")):
        with pytest.raises(ValueError, match=match):
            engine(mesh)


# --- the command line --------------------------------------------------------


def test_serve_shards_a_die_image(tmp_path, monkeypatch):
    """``--shards 2`` on a die image and DRAM-tier checkpoint of the port's
    ``deploy --store`` (llama3-405b at smoke: SwiGLU, d_ff 256): over
    [cpu] * 2 ``build_engine`` emits the JAX engine's greedy tokens on the
    same image, and ``serve`` runs the burst; the command line refuses 2
    shards on a host with one device of the kind."""
    from repro.launch import serve as jserve
    from repro_torch.launch import deploy as tdeploy
    from repro_torch.launch import serve as tserve
    arch, img = "llama3-405b", str(tmp_path / "nand.img")
    tdeploy.run_deploy(arch, True, None, str(tmp_path), store_path=img,
                       device="cpu")
    prompt = [5, 17, 29, 3]
    jeng = jserve.build_engine(arch, store_image=img, ckpt=str(tmp_path),
                               sample_cfg=JSample())
    rid = jeng.submit(prompt, max_new=8)
    want = jeng.run()[rid]
    eng = tserve.build_engine(arch, store_image=img, ckpt=str(tmp_path),
                              shards=2, mesh=["cpu"] * 2,
                              sample_cfg=SampleConfig(), device="cpu")
    assert eng.mesh.n_shards == 2 and eng.store.n_shards == 2
    rid = eng.submit(prompt, max_new=8)
    assert eng.run()[rid] == want
    eng.close()
    out = tserve.serve(arch, n_requests=3, max_new=4, store_image=img,
                       ckpt=str(tmp_path), shards=2, mesh=["cpu"] * 2,
                       device="cpu")
    assert out["tokens"] == 12 and out["stream"]["pool_shards"] == 2
    assert out["stream"]["pool_shard_transfers"] == \
        2 * out["stream"]["pool_uploads"]
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--store-image", img, "--ckpt",
        str(tmp_path), "--shards", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs 2 distinct cpu devices"):
        tserve.main()
    with pytest.raises(SystemExit, match="streamed planes"):
        tserve.build_engine(arch, shards=2, device="cpu")


def test_serve_shards_a_moe_die_image(tmp_path, monkeypatch):
    """``--shards 2`` on a MoE arch: a qwen3-moe-30b-a3b-smoke die image
    and DRAM-tier checkpoint of the port's ``deploy --store``, d_ff patched
    to 512 in both packages' configs (4 tiles of w_gate / w_up columns and
    w_down rows, 2 a shard); over [cpu] * 2 ``build_engine`` emits the JAX
    ``build_engine``'s greedy tokens on the same image, and ``serve`` runs
    the burst with one transfer per shard per upload."""
    import repro.launch.serve as jserve
    from repro.configs import get_config as jget
    from repro_torch.launch import deploy as tdeploy
    from repro_torch.launch import serve as tserve
    arch, img = "qwen3-moe-30b-a3b", str(tmp_path / "nand.img")

    def patched(get):
        def get_config_512(name, smoke=False):
            cfg = get(name, smoke=smoke)
            return (dataclasses.replace(cfg, d_ff=512) if name == arch
                    else cfg)
        return get_config_512
    monkeypatch.setattr(tdeploy, "get_config", patched(get_config))
    monkeypatch.setattr(tserve, "get_config", patched(get_config))
    monkeypatch.setattr(jserve, "get_config", patched(jget))
    tdeploy.run_deploy(arch, True, None, str(tmp_path), store_path=img,
                       device="cpu")
    prompt = [5, 17, 29, 3]
    jeng = jserve.build_engine(arch, store_image=img, ckpt=str(tmp_path),
                               sample_cfg=JSample())
    rid = jeng.submit(prompt, max_new=8)
    want = jeng.run()[rid]
    jeng.close()
    eng = tserve.build_engine(arch, store_image=img, ckpt=str(tmp_path),
                              shards=2, mesh=["cpu"] * 2,
                              sample_cfg=SampleConfig(), device="cpu")
    assert eng.streamed_moe and eng.mesh.n_shards == 2
    assert eng._expert_kn["w_down"] == (256, eng.cfg.d_model)
    rid = eng.submit(prompt, max_new=8)
    assert eng.run()[rid] == want
    eng.close()
    out = tserve.serve(arch, n_requests=3, max_new=4, store_image=img,
                       ckpt=str(tmp_path), shards=2, mesh=["cpu"] * 2,
                       device="cpu")
    assert out["tokens"] == 12 and out["stream"]["pool_shards"] == 2
    assert out["stream"]["pool_shard_transfers"] == \
        2 * out["stream"]["pool_uploads"]
