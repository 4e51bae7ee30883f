"""Tensor-parallel streamed serving of the MoE plane on the port (the
expert axis over shards: ``ShardedWeightPagePool`` partitions every routed
expert's w_gate / w_up by tile columns and w_down by tile rows, each shard
runs its d_ff/S slice through the grouped paged ECDP to an f32 partial
(``models/moe.serve_expert_ffn(partial=True)``) and ``all_reduce_sum``
completes the layer) against the JAX package, on the CPU, over meshes of one
CPU device repeated (``[cpu] * S``).

The config is the reference's own (tests/test_sharded_serving.py's
``test_sharded_moe_engine_token_parity``): qwen3-moe-30b-a3b-smoke with
d_ff 512, the JAX init's params carried across by ``interop``. Its prompts
(``[1..19]``, ``[9, 8, 7]``) are replaced by a margin-scanned pair of the
same lengths: the reference's ``[9, 8, 7]`` holds a near-tie in the JAX
engine's own logits (2e-4 between its top two at the third token) that the
port breaks the other way, unsharded and resident alike, because XLA's and
torch's CPU f32 sums over K = 512 part by an ulp and the model's bf16
roundings carry it to about 0.4 % of the logits. ``PAIR`` was the first of
numpy's ``default_rng(0)`` candidates (a 19- and a 3-token prompt) whose
emitted tokens all have a JAX top-2 margin of at least 0.025 and whose
routes a router k-th / (k+1)-th margin of at least 0.01 on the port.

The JAX unsharded streamed engine runs once on its CPU device; the JAX
sharded engine runs once in a subprocess with 4 forced virtual devices
(``reference_dump``), for its tokens and pool counters.
"""
from __future__ import annotations

import dataclasses
import functools
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

from repro.configs import get_config as jget
from repro.core import tiering as jtier
from repro.models import moe as jmoe
from repro.serving.engine import Engine as JEngine
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.erdpe import all_reduce_sum
from repro_torch.core.tiering import FlashWeight, PagedWeight, deploy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import Engine
from repro_torch.store import (PageStore, ShardedWeightPagePool, StreamConfig,
                               WeightPagePool)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
D_FF = 512
MAX_SEQ = 96
PAIR = ([402, 356, 90, 100, 192, 497, 15, 343, 151, 272, 45, 430, 447, 249,
         399, 244, 372, 132, 163], [80, 233, 364])
TP_ATOL, TP_RTOL = 1e-3, 1e-5      # the reference's psum bound
REF_KEYS = ("pool_shards", "pool_shard_transfers", "pool_uploads",
            "pool_local_pages", "pool_pages")


def _cfgs(**kw):
    kw.setdefault("d_ff", D_FF)
    return (dataclasses.replace(jget(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


@functools.lru_cache(maxsize=None)
def _params(n_layers: int = 2, d_ff: int = D_FF):
    """(JAX init params, the same params in the port)."""
    jcfg, _ = _cfgs(n_layers=n_layers, d_ff=d_ff)
    jp = jmoe.init(jcfg, jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _serve(eng, prompts=PAIR):
    rids = [eng.submit(list(p), max_new=8) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _no_prefetch(eng):
    """The router-history prefetch off: every miss is fetched on the compute
    path, so the pool's counters do not depend on the worker's timing."""
    eng._request_prefetch = lambda *a, **kw: None
    return eng


def _sharded(n_shards, cfg=None, params=None, **stream_kw):
    return Engine(cfg or _cfgs()[1], params or _params()[1], max_slots=2,
                  max_seq=MAX_SEQ, rber=0.0, weight_store=PageStore(n_planes=8),
                  stream_cfg=StreamConfig(n_shards=n_shards, **stream_kw),
                  device="cpu", mesh=["cpu"] * n_shards)


@functools.lru_cache(maxsize=None)
def _tier_bytes(n_layers: int = 2) -> int:
    probe = PageStore()
    deploy(_params(n_layers)[1], store=probe)
    return probe.total_bytes


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX streamed MoE engine's greedy tokens (one device, unsharded)."""
    eng = JEngine(_cfgs()[0], _params()[0], max_slots=2, max_seq=MAX_SEQ,
                  rber=0.0, weight_store=JPageStore(n_planes=8),
                  stream_cfg=JStreamConfig())
    out = _serve(eng)
    eng.close()
    return out


def _resident_local_pages(eng) -> int:
    """The pool slots the expert cache's entries hold (each shard's)."""
    cache = eng.expert_cache
    with cache._lock:
        return sum(len(e.value["slots"]) for e in cache._entries.values())


# --- (a) the engine against the JAX unsharded engine --------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("budget", [None, 0.8])
def test_sharded_moe_engine_emits_the_reference_tokens(jax_tokens, n_shards,
                                                       budget):
    """The streamed MoE plane over [cpu] * S emits the JAX unsharded
    streamed engine's greedy tokens, also under a device budget below the
    expert tier (the cache evicts and the pool really streams): every
    expert's banks bound shard-LOCAL, one staged transfer per shard per
    upload, each shard's partition on its mesh device, and no leaked
    slot."""
    kw = {} if budget is None else dict(
        device_budget_bytes=int(_tier_bytes() * budget))
    eng = _sharded(n_shards, **kw)
    assert isinstance(eng.wpool, ShardedWeightPagePool)
    f = D_FF // n_shards
    assert eng._expert_kn == {"w_gate": (64, f), "w_up": (64, f),
                              "w_down": (f, 64)}
    assert _serve(eng) == jax_tokens
    eng.prefetcher.drain()
    st = eng.expert_stats()
    assert st["pool_shards"] == n_shards
    assert st["pool_shard_transfers"] == n_shards * st["pool_uploads"] > 0
    assert all(b.device == d for b, d in zip(eng.wpool.buffer,
                                             eng.mesh.devices))
    assert st["pool_grows"] == 0
    if budget is not None:
        assert eng.store.total_bytes > kw["device_budget_bytes"]
        assert st["expert_cache_bytes"] <= eng.expert_cache.capacity
        assert st["misroute_stalls"] > 0
    assert eng.wpool.used_pages == _resident_local_pages(eng)
    eng.close()


# --- (b) the reference's sharded engine ---------------------------------------

_REF_DUMP = f"""
import dataclasses
import json
import jax
from repro.configs import get_config
from repro.models import moe
from repro.serving.engine import Engine
from repro.store import PageStore, StreamConfig
assert len(jax.devices()) == 4, jax.devices()
cfg = dataclasses.replace(get_config({ARCH!r}, smoke=True), d_ff={D_FF})
params = moe.init(cfg, jax.random.PRNGKey(0))
eng = Engine(cfg, params, max_slots=2, max_seq={MAX_SEQ}, rber=0.0,
             weight_store=PageStore(n_planes=8),
             stream_cfg=StreamConfig(n_shards=4))
eng._request_prefetch = lambda *a, **kw: None
rids = [eng.submit(list(p), max_new=8) for p in {PAIR!r}]
toks = eng.run()
st = eng.expert_stats()
eng.close()
print(json.dumps(dict(tokens=[toks[r] for r in rids],
                      **{{k: st[k] for k in {REF_KEYS!r}}})))
"""


@pytest.fixture(scope="module")
def reference_dump():
    """The reference's sharded MoE engine (S=4, 4 virtual CPU devices, its
    prefetch off), run once in a subprocess: its tokens and pool
    counters."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REF_DUMP], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_moe_engine_matches_the_reference_dump(reference_dump,
                                                       jax_tokens):
    """At S=4, with the prefetch off in both, the port's tokens and pool
    counters (shards, transfers, uploads, local pages, pages) are the
    reference's sharded MoE engine's."""
    eng = _no_prefetch(_sharded(4))
    assert _serve(eng) == reference_dump["tokens"] == jax_tokens
    st = eng.expert_stats()
    assert {k: st[k] for k in REF_KEYS} == \
        {k: reference_dump[k] for k in REF_KEYS}
    eng.close()


# --- (c) one layer's expert FFN -----------------------------------------------

def _expert_store(bank):
    """Layer 0's deployed bank programmed expert by expert under the
    engine's entry names (``tp_shard_axis`` reads them)."""
    store = PageStore(n_planes=8)
    for name, fw in bank.items():
        for e in range(fw.q.shape[0]):
            store.put(f"layers/moe/experts/{name}@0.{e}",
                      FlashWeight(fw.q[e], fw.parity[e], fw.scale[e]))
    return store


def _slab(pool_buf, tbls, perm, shard=None):
    """{name: PagedWeight} with the routed experts' tables stacked in slab
    order (shard ``shard``'s of a sharded pool)."""
    out = {}
    for name in ("w_gate", "w_up", "w_down"):
        ts = [tbls[f"layers/moe/experts/{name}@0.{e}"] for e in perm]
        dev = [t["dev"] if shard is None else t["dev_shards"][shard]
               for t in ts]
        out[name] = PagedWeight(pool_buf, *(torch.stack([d[j] for d in dev])
                                            for j in range(3)),
                                kn=tuple(ts[0]["kn"]))
    return out


def _reference_tp_ffn(bank, x, g, i):
    """The reference's tensor-parallel ``serve_expert_ffn(axis_name=)``
    over a one-device "model" mesh: the down product and the combine in
    f32, the psum, then the cast to bf16."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    fn = shard_map(functools.partial(jmoe.serve_expert_ffn,
                                     axis_name="model"),
                   mesh=mesh, in_specs=(P(),) * 4, out_specs=P(),
                   check_rep=False)
    return fn(bank, x, g, i)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("rber", [0.0, 1e-3])
def test_shard_partials_sum_to_the_expert_ffn(n_shards, rber):
    """Layer 0's expert FFN on a real route (layer 0's router on 32 lanes):
    the S shards' f32 partials over a sharded pool, summed by
    ``all_reduce_sum``, are within the reference's psum bound (rtol 1e-5,
    atol 1e-3) of the unsharded slab's f32 chain, and of the reference's
    tensor-parallel ``serve_expert_ffn`` on the full bank, whose output is
    cast to bf16 after its psum (half a bf16 ulp, 2^-9 of the value,
    more). The unsharded path is
    unchanged: its output is the f32 chain's combine with the down product
    rounded to bf16, bit for bit the deployed full bank's, and the shards
    given the shared dispatch (``expert_rows``) compute what they compute
    on their own."""
    jcfg, _ = _cfgs()
    jp, _ = _params()
    jd, _ = jtier.deploy(jp, rber=rber, seed=0)
    td = interop.deployed_from_numpy(jax.tree.map(np.asarray, jd),
                                     device="cpu")
    jbank = jax.tree.map(lambda a: a[0], jd["layers"]["moe"]["experts"])
    tbank = {k: v[0] for k, v in td["layers"]["moe"]["experts"].items()}
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (2, 16, jcfg.d_model)), jnp.bfloat16)
    g, i = jmoe.serve_route(jd["layers"]["moe"]["router"][0], x, jcfg.top_k)
    tx, tg, ti = (interop.tensor_from_numpy(np.asarray(a), device="cpu")
                  for a in (x, g, i))
    routed = sorted(set(np.asarray(i).ravel().tolist()))
    perm = routed[::-1]
    slab_map = torch.full((jcfg.n_experts,), -1, dtype=torch.int32)
    slab_map[torch.tensor(perm)] = torch.arange(len(perm), dtype=torch.int32)

    store = _expert_store(tbank)
    names = list(store.table)
    pages = sum(store.entry_pages(n) for n in names)
    pool1 = WeightPagePool(store, pages, device="cpu")
    mesh = tmesh.make_model_mesh(n_shards, devices=["cpu"] * n_shards)
    poolS = ShardedWeightPagePool(store, pages, mesh)
    t1, tS = pool1.upload(names), poolS.upload(names)
    whole = _slab(pool1.buffer, t1, perm)
    shards = [_slab(poolS.buffer[s], tS, perm, shard=s)
              for s in range(n_shards)]
    assert shards[0]["w_gate"].kn == (jcfg.d_model, D_FF // n_shards)
    assert shards[0]["w_down"].kn == (D_FF // n_shards, jcfg.d_model)

    partials = [tmoe.serve_expert_ffn(b, tx, tg, ti, slab_map, partial=True)
                for b in shards]
    assert all(p.dtype == torch.float32 for p in partials)
    got = all_reduce_sum(partials, mesh)
    want = tmoe.serve_expert_ffn(whole, tx, tg, ti, slab_map, partial=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TP_RTOL,
                               atol=TP_ATOL)
    jwant = np.asarray(_reference_tp_ffn(jbank, x, g, i), np.float32)
    err = np.abs(got.numpy() - jwant)
    assert (err <= TP_ATOL + (TP_RTOL + 2.0 ** -9) * np.abs(jwant)).all(), \
        float(err.max())
    # the shards' shared dispatch
    rows = tmoe.expert_rows(ti, slab_map, len(perm))
    for b, p in zip(shards, partials):
        assert torch.equal(tmoe.serve_expert_ffn(b, tx, tg, ti, slab_map,
                                                 partial=True, rows=rows), p)
    # the unsharded path: the down product rounded to bf16 before the
    # combine, as before; the slab gives the deployed full bank's output
    plain = tmoe.serve_expert_ffn(whole, tx, tg, ti, slab_map)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(plain, tmoe.serve_expert_ffn(tbank, tx, tg, ti))
    assert not torch.equal(plain.float(), want)
    np.testing.assert_allclose(plain.float().numpy(), want.numpy(),
                               rtol=2.0 ** -7, atol=TP_ATOL)


# --- (d) each shard's pool against its budget share ---------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_each_shard_pool_fits_its_budget_share(n_shards):
    """4 layers under half the expert tier: each shard's local pool is at
    most budget / S plus the engine's trace-static reserve, with the 8
    pages of page rounding scripts/bench_gate.py's serve_sharded gate
    allows (the reference's per-device bound as that gate holds it; the
    budget's conversion to pages rounds up), smaller than the tier's local
    pages (it really streams), the cache within its capacity, and the
    tokens the unsharded port engine's."""
    _, cfg = _cfgs(n_layers=4)
    params = _params(4)[1]
    budget = _tier_bytes(4) // 2
    eng = _sharded(n_shards, cfg=cfg, params=params,
                   device_budget_bytes=budget)
    toks = _serve(eng)
    eng.prefetcher.drain()
    st = eng.expert_stats()
    pb = eng.store.page_bytes
    assert st["pool_local_bytes"] == st["pool_local_pages"] * pb
    assert st["pool_local_bytes"] <= budget // n_shards + \
        st["pool_reserve_bytes"] + 8 * pb, (st["pool_local_bytes"], budget)
    tier_local = sum(eng._entry_pages_local(ref.entry(li, e))
                     for ref in eng._expert_refs.values()
                     for li in range(cfg.n_layers)
                     for e in range(cfg.n_experts))
    assert st["pool_local_pages"] < tier_local
    assert st["expert_cache_bytes"] <= eng.expert_cache.capacity
    assert st["pool_grows"] == 0
    eng.close()
    one = Engine(cfg, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                 weight_store=PageStore(n_planes=8),
                 stream_cfg=StreamConfig(device_budget_bytes=budget),
                 device="cpu")
    assert _serve(one) == toks
    one.close()


# --- (e) a 6-tile d_ff --------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_six_tile_expert_grid(n_shards):
    """d_ff 768 (qwen3-moe-30b-a3b's: 6 tiles of 128) at the smoke width:
    S = 2 and 3 partition it and serve, S = 4 is refused loudly, never
    replicated (the all-reduce would count the down product 4 times)."""
    _, cfg = _cfgs(d_ff=768)
    params = _params(2, 768)[1]
    if n_shards == 4:
        with pytest.raises(ValueError, match="cannot partition"):
            _sharded(4, cfg=cfg, params=params)
        return
    eng = _sharded(n_shards, cfg=cfg, params=params)
    f = 768 // n_shards
    assert eng._expert_kn == {"w_gate": (64, f), "w_up": (64, f),
                              "w_down": (f, 64)}
    out = _serve(eng, ([5, 6, 7, 8],))
    assert len(out[0]) == 8 and all(0 <= t < cfg.vocab_size for t in out[0])
    st = eng.expert_stats()
    assert st["pool_shard_transfers"] == n_shards * st["pool_uploads"]
    eng.close()
