"""The flash tier encoded as it is drawn (``tiering.deploy_init``): byte for
byte what ``deploy(init(...))`` gives in the port, with and without a page
store, and what the JAX ``deploy`` gives on the JAX init's matrices fed
through the same per-matrix encode and sorted programming; the engines
``build_engine`` makes from it against ``Engine(cfg, init(...))``; no bf16
stack of a flash leaf ever allocated; the restore template on the meta
device, and ``run_deploy``'s restore through it."""
from __future__ import annotations

import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import tiering as jtier
from repro.models import dense as jdense
from repro.models import moe as jmoe
from repro.store import PageStore as JPageStore
from repro_torch import interop
from repro_torch.configs import OPT_TINY, get_config
from repro_torch.core import tiering as ttier
from repro_torch.launch import serve as tserve
from repro_torch.models import dense as tdense
from repro_torch.models import family_module
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleConfig
from repro_torch.store import PageStore

torch.set_num_threads(2)

ARCHS = ["opt-tiny", "granite-8b", "qwen3-moe-30b-a3b"]


def _cfg(arch):
    return OPT_TINY if arch == "opt-tiny" else get_config(arch, smoke=True)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _flat(tree):
    return dict(ttier._walk(tree))


def _table(store):
    return {n: {c: comp.to_json() for c, comp in e.items()}
            for n, e in store.table.items()}


def _same_tiered(got, want):
    """Leaf by leaf: FlashWeight bytes, StoreRefs, bf16 DRAM leaves."""
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for path, w in fw.items():
        g = fg[path]
        if isinstance(w, ttier.FlashWeight):
            assert isinstance(g, ttier.FlashWeight), path
            for field in ("q", "parity", "scale"):
                a, b = getattr(g, field), getattr(w, field)
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (path, field)
        elif getattr(w, "is_store_ref", False):
            assert g == w, path
        else:
            assert g.dtype == torch.bfloat16 and torch.equal(g, w), path


def _same_store(got, want):
    assert got.n_pages == want.n_pages
    assert got.total_bytes == want.total_bytes
    np.testing.assert_array_equal(got._data[:got.n_pages],
                                  np.asarray(want._data[:want.n_pages]))
    assert _table(got) == _table(want)


# --- port against port -------------------------------------------------------

@pytest.mark.parametrize("store", [False, True], ids=["device", "store"])
@pytest.mark.parametrize("rber", [0.0, 1e-3])
@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_init_equals_deploy_of_init(arch, rber, store):
    cfg = _cfg(arch)
    mod = family_module(cfg.family)
    s_want = PageStore() if store else None
    s_got = PageStore() if store else None
    want, want_map = ttier.deploy(mod.init(cfg, _gen(), device="cpu"),
                                  rber=rber, seed=5, store=s_want)
    got, got_map = ttier.deploy_init(cfg, _gen(), rber=rber, seed=5,
                                     store=s_got, device="cpu")
    assert got_map == want_map
    assert list(got_map.values()).count("flash") == \
        (4 if cfg.ffn_type == "swiglu" or cfg.family == "moe" else 3)
    _same_tiered(got, want)
    assert ttier.flash_bytes(got) == ttier.flash_bytes(want)
    if store:
        _same_store(s_got, s_want)


def test_deploy_passes_flash_weights_through():
    """A tree that is tiered already deploys to itself (the engine's
    deploy of ``deploy_init``'s tree), and into a store as ``deploy(init)``
    programs it."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    tiered, tier_map = ttier.deploy_init(cfg, _gen(), rber=1e-3, seed=5,
                                         device="cpu")
    again, again_map = ttier.deploy(tiered, rber=0.5, seed=99)
    assert again_map == tier_map
    _same_tiered(again, tiered)
    s_got, s_want = PageStore(), PageStore()
    ttier.deploy(tiered, store=s_got)
    ttier.deploy(tmoe.init(cfg, _gen(), device="cpu"), rber=1e-3, seed=5,
                 store=s_want)
    _same_store(s_got, s_want)


def test_deploy_init_frees_each_leaf_once_the_store_holds_it(monkeypatch):
    """With a store, each encoded leaf is gone before the next one is
    programmed: the host holds the leaves still to program, not the tier
    beside its pages."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    store = PageStore()
    put, programmed = store.put_param, []

    def recording(name, fw):
        assert all(r() is None for r in programmed), name
        programmed.append(weakref.ref(fw.q))
        return put(name, fw)

    monkeypatch.setattr(store, "put_param", recording)
    tiered, _ = ttier.deploy_init(cfg, _gen(), rber=1e-3, store=store,
                                  device="cpu")
    assert len(programmed) == 4 and all(r() is None for r in programmed)
    assert all(getattr(_flat(tiered)[p], "is_store_ref", False)
               for p in ("lm_head", "layers/moe/experts/w_down"))


def test_engine_takes_store_refs_only_streamed():
    """A tree of StoreRefs is the streamed engine's, over the store they
    were programmed into; a resident engine refuses it."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    tiered, _ = ttier.deploy_init(cfg, _gen(), store=PageStore(),
                                  device="cpu")
    with pytest.raises(ValueError, match="StoreRef"):
        Engine(cfg, tiered, device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-medium"])
def test_deploy_init_of_the_other_families_is_deploy_of_init(arch):
    cfg = get_config(arch, smoke=True)
    want, want_map = ttier.deploy(
        family_module(cfg.family).init(cfg, _gen(), device="cpu"),
        rber=1e-3, seed=2)
    got, got_map = ttier.deploy_init(cfg, _gen(), rber=1e-3, seed=2,
                                     device="cpu")
    assert got_map == want_map
    _same_tiered(got, want)


def test_encode_flash_is_the_encoder_over_the_stack():
    w = torch.randn((3, 2, 64, 40), generator=_gen()).to(torch.bfloat16)
    enc = ttier.FlashEncoder(tuple(w.shape), "cpu", rber=2e-3, seed=7)
    for i, m in enumerate(w.reshape(6, 64, 40)):
        enc.put(i, m)
    got = enc.finish()
    want = ttier.encode_flash(w, rber=2e-3, seed=7)
    assert got.shape == want.shape == (3, 2, 64, 40)
    assert got.parity.shape == (3, 2, 8, 40)
    assert got.scale.shape == (3, 2, 1, 40)
    for field in ("q", "parity", "scale"):
        assert torch.equal(getattr(got, field), getattr(want, field))
    with pytest.raises(ValueError):
        ttier.FlashEncoder((40,), "cpu")


# --- against the reference ---------------------------------------------------

def _jax_params(arch):
    if arch == "opt-tiny":
        return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))
    return jmoe.init(jget(arch, smoke=True), jax.random.PRNGKey(0))


def _feeding_init(np_params):
    """A family ``init`` that hands the JAX init's matrices to deploy_init's
    sink one (K, N) matrix at a time, as the port's own ``init`` hands its
    draws."""
    def init(cfg, gen, device="cuda", sink=None):
        def rec(tree, prefix):
            out = {}
            for key, v in tree.items():
                path = f"{prefix}{key}"
                if isinstance(v, dict):
                    out[key] = rec(v, path + "/")
                    continue
                enc = None if sink is None else sink(path, tuple(v.shape))
                t = interop.tensor_from_numpy(v, device)
                if enc is None:
                    out[key] = t
                    continue
                for i, m in enumerate(t.reshape((-1,) + t.shape[-2:])):
                    enc.put(i, m)
                out[key] = enc.finish()
            return out
        return rec(np_params, "")
    return init


@pytest.mark.parametrize("store", [False, True], ids=["device", "store"])
@pytest.mark.parametrize("rber", [0.0, 1e-3])
@pytest.mark.parametrize("arch", ["opt-tiny", "qwen3-moe-30b-a3b"])
def test_deploy_init_on_the_jax_init_equals_the_jax_deploy(
        arch, rber, store, monkeypatch):
    jp = _jax_params(arch)
    np_params = jax.tree.map(np.asarray, jp)
    cfg = _cfg(arch)
    monkeypatch.setattr(tdense if cfg.family == "dense" else tmoe, "init",
                        _feeding_init(np_params))
    js = JPageStore() if store else None
    ts = PageStore() if store else None
    jt, jmap = jtier.deploy(jp, rber=rber, seed=3, store=js)
    tt, tmap = ttier.deploy_init(cfg, _gen(), rber=rber, seed=3, store=ts,
                                 device="cpu")
    assert tmap == jmap
    want = interop.deployed_from_numpy(jax.tree.map(np.asarray, jt),
                                       device="cpu") if not store else None
    if store:
        _same_store(ts, js)
        assert ttier.flash_bytes(tt) == jtier.flash_bytes(jt)
        flat_j = dict(ttier._walk(jt))
        for path, ref in _flat(tt).items():
            if getattr(ref, "is_store_ref", False):
                j = flat_j[path]
                assert (ref.name, tuple(ref.shape), ref.nbytes,
                        tuple(ref.lead)) == \
                    (j.name, tuple(j.shape), j.nbytes, tuple(j.lead))
    else:
        _same_tiered(tt, want)


# --- the engine --------------------------------------------------------------

PROMPTS = {"opt-tiny": ([5, 9, 2, 7, 11, 3], [40, 41]),
           "qwen3-moe-30b-a3b": (list(range(33, 52)), [384, 8, 157])}


def _steps(eng, prompts, max_new=6):
    rids = [eng.submit(list(p), max_new=max_new) for p in prompts]
    logits = []
    while eng.step():
        logits.append(eng.last_logits.clone())
    out = [list(eng.requests[r].out) for r in rids]
    eng.close()
    return out, logits


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("arch", ["opt-tiny", "qwen3-moe-30b-a3b"])
def test_build_engine_serves_what_an_engine_over_init_serves(arch, stream):
    cfg = _cfg(arch)
    mod = family_module(cfg.family)
    kw = {}
    got = _steps(tserve.build_engine(arch, rber=1e-3, seed=4, stream=stream,
                                     sample_cfg=SampleConfig(),
                                     device="cpu"), PROMPTS[arch])
    params = mod.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    if stream:
        from repro_torch.store import StreamConfig
        kw = dict(weight_store=PageStore(), stream_cfg=StreamConfig())
    want = _steps(Engine(cfg, params, max_slots=4, max_seq=256, rber=1e-3,
                         seed=4, sample_cfg=SampleConfig(), device="cpu",
                         **kw), PROMPTS[arch])
    assert got[0] == want[0] and all(len(o) == 6 for o in got[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


# --- memory ------------------------------------------------------------------

def _recording(monkeypatch):
    """Record the (shape, dtype) of every torch.empty / zeros / randn call."""
    seen = []

    def wrap(fn):
        def rec(*shape, **kw):
            size = shape[0] if len(shape) == 1 and isinstance(
                shape[0], (tuple, list, torch.Size)) else shape
            seen.append((tuple(int(d) for d in size),
                         kw.get("dtype") or torch.get_default_dtype()))
            return fn(*shape, **kw)
        return rec
    for name in ("empty", "zeros", "randn"):
        monkeypatch.setattr(torch, name, wrap(getattr(torch, name)))
    return seen


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_deploy_init_never_allocates_a_flash_stack_in_bf16(arch,
                                                           monkeypatch):
    """No bf16 (or f32) tensor of a stacked flash leaf's shape is asked
    for, where ``deploy(init(...))`` asks for one per stacked leaf."""
    cfg = _cfg(arch)
    tiered, tier_map = ttier.deploy_init(cfg, _gen(), device="cpu")
    stacks = {tuple(leaf.shape) for p, leaf in _flat(tiered).items()
              if tier_map[p] == "flash" and len(leaf.shape) > 2}
    assert len(stacks) >= 2
    wide = (torch.bfloat16, torch.float32)

    def stacked(seen):
        return [(s, dt) for s, dt in seen if s in stacks and dt in wide]

    seen = _recording(monkeypatch)
    ttier.deploy_init(cfg, _gen(), rber=1e-3, device="cpu")
    assert seen and not stacked(seen), stacked(seen)
    seen.clear()
    ttier.deploy(family_module(cfg.family).init(cfg, _gen(), device="cpu"))
    assert {s for s, _ in stacked(seen)} == stacks       # the check bites


# --- the restore template ----------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b"])
def test_init_template_is_the_init_tree_on_meta(arch):
    cfg = get_config(arch, smoke=True)
    real = family_module(cfg.family).init(cfg, _gen(), device="cpu")
    meta = ttier.init_template(cfg)
    fr, fm = _flat(real), _flat(meta)
    assert fr.keys() == fm.keys()
    for p, t in fr.items():
        assert fm[p].is_meta and fm[p].shape == t.shape \
            and fm[p].dtype == t.dtype, p
    full = ttier.dram_tier(ttier.init_template(get_config(arch)))
    assert all(t.is_meta for t in _flat(full).values())


@pytest.mark.parametrize("train", [False, True], ids=["params", "train"])
def test_run_deploy_restores_through_the_meta_template(train, tmp_path,
                                                       monkeypatch):
    """``run_deploy --ckpt`` restores into ``init_template``'s meta tree:
    no number is drawn (``torch.randn`` raises here), and it writes what
    ``deploy`` of the saved params writes, from a params checkpoint and
    from a training one (params, AdamW state)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import deploy as tdeploy
    from repro_torch.optim.adamw import AdamWState

    cfg = get_config("granite-8b", smoke=True)
    params = tdense.init(cfg, _gen(), device="cpu")
    state = AdamWState(step=torch.zeros((), dtype=torch.int32), m=params,
                       v=params)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, (params, state) if train else params)
    want, _ = ttier.deploy(params, rber=1e-3, seed=2)
    CheckpointManager(str(tmp_path / "want")).save(0, want)

    def no_draw(*a, **k):
        raise AssertionError("the restore template drew numbers")

    monkeypatch.setattr(torch, "randn", no_draw)
    tdeploy.run_deploy("granite-8b", True, str(tmp_path / "ckpt"),
                       str(tmp_path / "got"), rber=1e-3, seed=2,
                       device="cpu")
    (got,), (ref,) = (list((tmp_path / d).rglob("arrays.npz"))
                      for d in ("got", "want"))
    with np.load(got) as zg, np.load(ref) as zw:
        assert sorted(zg.files) == sorted(zw.files)
        for k in zw.files:
            np.testing.assert_array_equal(zg[k], zw[k])
