"""Speculative decoding in the port (``serving/spec.py`` and the engine's
verify lanes, resident plane) against the JAX package on the same inputs.

The parts: ``ngram_propose`` byte-equal to the reference's (its four
cases and random histories), greedy ``verify_lanes`` equal on random
logits (ties included: both take the first index), the deterministic
rejection extremes, the ``SpecConfig`` errors, and ``PagedKVPool.rewind``
with tables, lengths and free counts equal to the JAX pool's after every
operation of the reference's hypothesis property.

The engine: the tests/test_spec.py scenarios on the port's CPU engine
(plain kernel versions, the static-buffer step body) with params carried
across from ``dense.init(OPT_TINY, PRNGKey(0))``: the same greedy tokens
as the JAX spec engine and the JAX vanilla engine, and in greedy runs the
same ``spec_stats`` and per-step stats. Non-greedy tokens cannot match (a
``torch.Generator`` is not a JAX key), so the temperature scenario
compares counts and ranges. As in the reference, ``kv_aware=False``: the
Algorithm 2 bitmap moves per step, and spec and vanilla engines take
different step trajectories.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hyp_compat import given, settings, st

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core.scheduler import AdmissionConfig as JAdmission
from repro.models import dense as jdense
from repro.serving import spec as jspec
from repro.serving.engine import Engine as JEngine
from repro.serving.kvcache import PagedKVPool as JPool
from repro.serving.sampler import SampleConfig as JSample
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.core.scheduler import AdmissionConfig
from repro_torch.serving import spec
from repro_torch.serving.engine import Engine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.sampler import SampleConfig, categorical

torch.set_num_threads(2)

MAX_SEQ = 96
# Prompts scanned on the port for solid greedy margins: every emitted
# token's top-2 logit margin is >= 0.049, in the vanilla run and on the
# spec run's verify lanes (one prefill chunk each, 16 new tokens). The
# reference's own PROMPTS ([13]*8, [255]*8, [450]*8) are not: at [450]*8's
# second token the margin is 3.8e-4, at [13]*8's ninth 4.9e-3 (vanilla)
# against 1.2e-3 the other way on the verify lane, and there the port's
# engines break the ties unlike the JAX compiled engines (ROADMAP §C).
PROMPTS = [[28] * 8, [88] * 8, [175] * 8]


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# --- drafters ------------------------------------------------------------------

# tests/test_spec.py's four cases: (history, lens, k, n_max)
NGRAM_CASES = {
    "finds_repetition": ([[5, 6, 1, 2, 3, 9, 1, 2, 3, 0, 0, 0]], [9], 3, 3),
    "most_recent_match": ([[1, 2, 40, 3, 1, 2, 50, 4, 1, 2, 0, 0]], [10],
                          2, 3),
    "no_match": ([[1, 2, 3, 4, 5, 6, 0, 0], [7, 0, 0, 0, 0, 0, 0, 0]],
                 [6, 1], 3, 3),
    "clips_at_history_end": ([[1, 2, 3, 9, 1, 2, 3, 0]], [7], 6, 3),
}
NGRAM_WANT = {"finds_repetition": ([[9, 1, 2]], [3]),
              "most_recent_match": ([[50, 4]], [2]),
              "no_match": (None, [0, 0]),
              "clips_at_history_end": ([[9, 1, 2, 3, 0, 0]], [4])}


def _ngram_both(hist, lens, k, n_max):
    got = spec.ngram_propose(_i32(hist), _i32(lens), k, n_max)
    want = jspec.ngram_propose(jnp.asarray(hist, jnp.int32),
                               jnp.asarray(lens, jnp.int32), k, n_max)
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


@pytest.mark.parametrize("case", list(NGRAM_CASES))
def test_ngram_propose_equals_the_reference(case):
    (d, n), (jd, jn) = _ngram_both(*NGRAM_CASES[case])
    assert d.dtype == jd.dtype == np.int32 and n.dtype == jn.dtype
    assert d.tobytes() == jd.tobytes() and n.tobytes() == jn.tobytes()
    want_d, want_n = NGRAM_WANT[case]
    assert n.tolist() == want_n
    if want_d is not None:
        assert d.tolist() == want_d


@settings(max_examples=50, deadline=None)
@given(data=st.data(), k=st.integers(1, 6), n_max=st.integers(1, 4),
       vocab=st.integers(1, 5))
def test_ngram_propose_random_histories(data, k, n_max, vocab):
    """Random (4, 20) histories over a small vocabulary (so n-grams recur)
    and lengths from 0 to the whole history: drafts and n_avail
    byte-equal. One history shape keeps JAX's op cache warm."""
    b, h = 4, 20
    hist = data.draw(st.lists(st.lists(st.integers(0, vocab - 1),
                                       min_size=h, max_size=h),
                              min_size=b, max_size=b))
    lens = data.draw(st.lists(st.integers(0, h), min_size=b, max_size=b))
    (d, n), (jd, jn) = _ngram_both(hist, lens, k, n_max)
    assert d.tobytes() == jd.tobytes()
    assert n.tobytes() == jn.tobytes()


# --- verify_lanes ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_greedy_verify_equals_the_reference(seed):
    """Random lane logits, drafts that partly agree with the lane argmax,
    random n_draft: tokens and n_accept equal. Even seeds draw integer
    logits from a small range, so lanes hold ties (first index wins in
    both packages)."""
    rng = np.random.default_rng(seed)
    b, k, v = 5, 4, 33
    if seed % 2:
        logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    else:
        logits = rng.integers(0, 3, (b, k + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = np.where(rng.random((b, k)) < 0.7, tgt[:, :k],
                      rng.integers(0, v, (b, k))).astype(np.int32)
    n_draft = rng.integers(0, k + 1, b).astype(np.int32)
    toks, n_acc = spec.verify_lanes(torch.from_numpy(logits),
                                    _i32(drafts), _i32(n_draft), None,
                                    SampleConfig())
    jt, jn = jspec.verify_lanes(jnp.asarray(logits), jnp.asarray(drafts),
                                jnp.asarray(n_draft), jax.random.PRNGKey(0),
                                JSample())
    assert toks.numpy().tobytes() == np.asarray(jt).tobytes()
    assert n_acc.numpy().tobytes() == np.asarray(jn).tobytes()
    assert n_acc.numpy().max() > 0


def _onehot_logits(rows):
    """(1, K+1, 16) logits putting ~all mass on the given token per lane."""
    out = np.full((1, len(rows), 16), -30.0, np.float32)
    for i, t in enumerate(rows):
        out[0, i, t] = 30.0
    return out


@pytest.mark.parametrize("drafts,n_draft,want_n,want", [
    ([3, 5, 2], 3, 2, [3, 5, 7]),        # reject lane 2: residual still 7
    ([3, 5, 7], 3, 3, [3, 5, 7, 9]),     # all accepted: the bonus lane
    ([5, 5, 5], 0, 0, [3]),              # no drafts: plain decode
], ids=["reject", "accept_all", "no_drafts"])
@pytest.mark.parametrize("temperature", [0.0, 1.0],
                         ids=["greedy", "rejection"])
def test_verify_extremes_equal_the_reference(drafts, n_draft, want_n, want,
                                             temperature):
    """tests/test_spec.py's extremes: with ~one-hot targets rejection
    sampling is deterministic, so both packages emit the same tokens
    whatever their draws, over several seeds."""
    logits = _onehot_logits([3, 5, 7, 9])
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        toks, n_acc = spec.verify_lanes(
            torch.from_numpy(logits), _i32([drafts]), _i32([n_draft]), gen,
            SampleConfig(temperature=temperature))
        jt, jn = jspec.verify_lanes(
            jnp.asarray(logits), jnp.asarray([drafts], jnp.int32),
            jnp.asarray([n_draft], jnp.int32), jax.random.PRNGKey(seed),
            JSample(temperature=temperature))
        assert int(n_acc[0]) == int(jn[0]) == want_n
        assert toks[0, :want_n + 1].tolist() == \
            np.asarray(jt)[0, :want_n + 1].tolist() == want


def test_lane_draws_are_independent():
    """The counterpart of the reference's ``lane_keys`` test: identical
    logits on every lane do not give identical draws; greedy ignores the
    generator."""
    out = categorical(torch.zeros((1, 8, 64)), torch.Generator().manual_seed(1))
    assert out.shape == (1, 8) and out.dtype == torch.int32
    assert len(set(out[0].tolist())) > 1
    toks, _ = spec.verify_lanes(torch.from_numpy(_onehot_logits([3, 5, 7, 9])),
                                _i32([[0, 0, 0]]), _i32([0]), None,
                                SampleConfig())
    assert toks[0].tolist() == [3, 5, 7, 9]


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=2, drafter="medusa"),
                                dict(k=2, ngram=0),
                                dict(k=2, adaptive_k=True, ema_alpha=0.0),
                                dict(k=2, ema_alpha=1.5)],
                         ids=["k0", "drafter", "ngram0", "alpha0", "alpha>1"])
def test_spec_config_errors_equal_the_reference(kw):
    with pytest.raises(ValueError) as got:
        spec.SpecConfig(**kw)
    with pytest.raises(ValueError) as want:
        jspec.SpecConfig(**kw)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(spec.SpecConfig()) == \
        dataclasses.asdict(jspec.SpecConfig())


# --- the pool's length rewind ------------------------------------------------------

def _pool_view(pool):
    return (pool.block_tables.tolist(), pool.lengths.tolist(),
            sorted(pool.free_blocks), pool.n_free_blocks,
            pool.ref_count.tolist(), pool.reserved.tolist())


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 15)),
                    min_size=1, max_size=60),
       n_blocks=st.integers(4, 12))
def test_pool_rewind_equals_the_reference(ops, n_blocks):
    """tests/test_spec.py's random alloc/ensure/rewind/release
    interleavings on the port's pool and the JAX pool side by side: equal
    tables, lengths, free lists, ref counts and reservations after every
    operation, and the reference's invariants on the port's."""
    pool = PagedKVPool(1, 2, 16, 2, 4, block_size=4, n_blocks=n_blocks,
                       device="cpu")
    jpool = JPool(1, 2, 16, 2, 4, block_size=4, n_blocks=n_blocks)
    free0 = pool.n_free_blocks
    live: dict[int, int] = {}                     # slot -> reserved rows
    rid = 0
    for op, arg in ops:
        if op == 0:                               # alloc
            need = arg + 1
            if pool.blocks_for(need) > pool.max_blocks:
                continue
            slot = pool.alloc(rid, need)
            assert jpool.alloc(rid, need) == slot
            if slot is not None:
                live[slot] = need
                rid += 1
        elif op == 1 and live:                    # ensure (spec max lanes)
            slot = sorted(live)[arg % len(live)]
            new_len = min(int(pool.lengths[slot]) + arg % 5, live[slot])
            pool.ensure(slot, new_len)
            jpool.ensure(slot, new_len)
        elif op == 2 and live:                    # rewind to accepted length
            slot = sorted(live)[arg % len(live)]
            pool.rewind(slot, min(arg, pool.capacity(slot)))
            jpool.rewind(slot, min(arg, jpool.capacity(slot)))
        elif op == 3 and live:                    # release
            slot = sorted(live)[arg % len(live)]
            pool.release(slot)
            jpool.release(slot)
            del live[slot]
        assert _pool_view(pool) == _pool_view(jpool)
        mapped = pool.block_tables[pool.block_tables != 0]
        assert len(set(mapped.tolist())) == len(mapped), "block double-mapped"
        for blk in range(1, pool.n_blocks):
            assert pool.ref_count[blk] == int(
                np.count_nonzero(pool.block_tables == blk))
        assert not (set(pool.free_blocks) & set(mapped.tolist()))
        for slot in live:
            assert 0 <= pool.lengths[slot] <= pool.capacity(slot)
    for slot in list(live):
        pool.release(slot)
    assert pool.n_free_blocks == free0, "blocks leaked across rollbacks"


def test_rewind_asserts_as_the_reference():
    pool = PagedKVPool(1, 2, 16, 2, 4, block_size=4, device="cpu")
    slot = pool.alloc(0, 8)
    pool.ensure(slot, 5)
    with pytest.raises(AssertionError, match="capacity"):
        pool.rewind(slot, 9)
    with pytest.raises(AssertionError, match="inactive"):
        pool.rewind(1 - slot, 0)
    pool.rewind(slot, 8)
    assert pool.lengths[slot] == 8 and pool.n_mapped(slot) == 2


# --- the engine ---------------------------------------------------------------------

DRAFT_KW = dict(name="opt-draft", n_layers=2, d_model=64, n_heads=2,
                n_kv_heads=2, head_dim=32, d_ff=128)   # tests/test_spec.py's


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


def _cross(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


@pytest.fixture(scope="module")
def params(jax_params):
    return _cross(jax_params)


def _draft(seed, **kw):
    """A draft model's JAX params and the port's copy."""
    jcfg = dataclasses.replace(J_OPT_TINY, **kw)
    jp = jdense.init(jcfg, jax.random.PRNGKey(seed))
    return (jcfg, jp), (dataclasses.replace(OPT_TINY, **kw), _cross(jp))


def _spec_cfgs(**kw):
    return spec.SpecConfig(**kw), jspec.SpecConfig(**kw)


def _engines(jax_params, params, spec_kw=None, draft=None, sample=None,
             admission=None, **kw):
    """A port engine and a JAX engine built alike (kv_aware=False)."""
    kw.setdefault("kv_aware", False)
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    tk, jk = dict(kw, device="cpu"), dict(kw)
    if spec_kw is not None:
        tk["spec_cfg"], jk["spec_cfg"] = _spec_cfgs(**spec_kw)
    if draft is not None:
        (jk["draft_cfg"], jk["draft_params"]), \
            (tk["draft_cfg"], tk["draft_params"]) = draft
    if sample is not None:
        tk["sample_cfg"], jk["sample_cfg"] = SampleConfig(**sample), \
            JSample(**sample)
    if admission is not None:
        tk["admission_cfg"] = AdmissionConfig(**admission)
        jk["admission_cfg"] = JAdmission(**admission)
    return (Engine(OPT_TINY, params, rber=0.0, **tk),
            JEngine(J_OPT_TINY, jax_params, rber=0.0, **jk))


def _serve(eng):
    rids = [eng.submit(list(p), max_new=16) for p in PROMPTS]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def greedy_reference(jax_params):
    """The JAX vanilla engine's greedy outputs: the parity oracle."""
    return _serve(JEngine(J_OPT_TINY, jax_params, max_slots=3,
                          max_seq=MAX_SEQ, rber=0.0, kv_aware=False))


def _same_run(eng, jeng):
    assert eng.stats == jeng.stats
    assert eng.spec_stats() == jeng.spec_stats()
    np.testing.assert_array_equal(eng.pool.lengths, jeng.pool.lengths)


def test_spec_resident_matches_the_reference(jax_params, params,
                                             greedy_reference):
    eng, jeng = _engines(jax_params, params, spec_kw=dict(k=4))
    out, jout = _serve(eng), _serve(jeng)
    assert out == jout == greedy_reference
    _same_run(eng, jeng)
    assert eng.step_traces == 0          # the body, no capture, on the CPU
    st = eng.spec_stats()
    assert st["spec_accepted"] > 0 and st["spec_tokens_per_step"] > 1.0
    assert len(eng.stats) < sum(len(o) for o in out)
    assert eng.last_lane_logits.shape == (3, 5, OPT_TINY.vocab_size)


def test_spec_model_drafter_matches_the_reference(jax_params, params,
                                                  greedy_reference):
    """An unrelated draft model proposes junk: the stream is still the
    greedy reference, the drafts and counts the JAX engine's."""
    eng, jeng = _engines(jax_params, params,
                         spec_kw=dict(k=3, drafter="model", draft_window=12),
                         draft=_draft(7, **DRAFT_KW))
    out, jout = _serve(eng), _serve(jeng)
    assert out == jout == greedy_reference
    _same_run(eng, jeng)
    assert eng.spec_stats()["spec_tokens_per_step"] >= 1.0


def test_model_propose_equals_the_reference():
    """The draft model's rollout over histories shorter and longer than
    its window: the same drafts."""
    (jcfg, jp), (tcfg, tp) = _draft(7, **DRAFT_KW)
    rng = np.random.default_rng(5)
    hist = rng.integers(0, OPT_TINY.vocab_size, (3, 40)).astype(np.int32)
    lens = np.array([0, 5, 40], np.int32)
    d, n = spec.DraftProposer(spec.SpecConfig(k=3, drafter="model",
                                              draft_window=12),
                              tcfg, tp).propose(_i32(hist), _i32(lens))
    jd, jn = jspec.model_propose(jcfg, jp, jnp.asarray(hist),
                                 jnp.asarray(lens), 3, 12)
    assert n.tolist() == np.asarray(jn).tolist() == [0, 3, 3]
    assert d.tolist() == np.asarray(jd).tolist()


def test_spec_temperature_emits_exact_counts(jax_params, params):
    eng, jeng = _engines(jax_params, params, spec_kw=dict(k=3),
                         sample=dict(temperature=0.8, top_k=40))
    out, jout = _serve(eng), _serve(jeng)
    for o in (out, jout):
        assert [len(x) for x in o] == [16, 16, 16]
        assert all(0 <= t < OPT_TINY.vocab_size for x in o for t in x)
    st = eng.spec_stats()
    assert st["spec_verify_steps"] > 0 and st["spec_drafted"] > 0
    assert st["spec_accepted"] <= st["spec_drafted"]


def test_spec_device_lengths_track_host_mirror(jax_params, params):
    """The KV rewind is host + device coupled: after every step the
    device lengths equal the host mirror, and the JAX engine's. The
    reference's prompts shifted by one ([1, 2, 3, 4] * 3 and [5, 5, 5]
    carry greedy margins of 2e-4 and 8e-3 on the port; these, 0.10 and
    0.049)."""
    eng, jeng = _engines(jax_params, params, spec_kw=dict(k=4), max_slots=2)
    for e in (eng, jeng):
        e.submit([2, 3, 4, 5] * 3, max_new=12)
        e.submit([6, 6, 6], max_new=9)
    while any(not r.done for r in eng.requests.values()):
        eng.step()
        jeng.step()
        np.testing.assert_array_equal(eng.pool.lengths_dev.numpy(),
                                      eng.pool.lengths)
        np.testing.assert_array_equal(eng.pool.lengths,
                                      np.asarray(jeng.pool.lengths_dev))
    assert all(r.done for r in jeng.requests.values())
    assert [r.out for r in eng.requests.values()] == \
        [r.out for r in jeng.requests.values()]
    _same_run(eng, jeng)


def test_spec_respects_max_new_and_reservation(jax_params, params):
    eng, jeng = _engines(jax_params, params, spec_kw=dict(k=4), max_slots=1,
                         max_seq=32)
    outs = []
    for e in (eng, jeng):
        rid = e.submit([4, 4, 4, 4], max_new=3)     # tiny budget vs k=4
        outs.append(e.run()[rid])
    assert len(outs[0]) == 3 and outs[0] == outs[1]
    _same_run(eng, jeng)


def test_spec_decode_continues_during_prefill(jax_params, params):
    """While a long prompt prefills in chunks, a speculating decoder still
    emits >= 1 token a step, the prefill completes, and every token and
    step equals the JAX engine's."""
    eng, jeng = _engines(jax_params, params, spec_kw=dict(k=4), max_slots=2,
                         admission=dict(chunk_tokens=8, token_budget=16))
    runs = []
    for e in (eng, jeng):
        r1 = e.submit([255] * 8, max_new=60)
        for _ in range(3):
            e.step()                               # r1 is decoding now
        before = len(e.requests[r1].out)
        r2 = e.submit(list(range(1, 41)), max_new=4)   # 5 chunks
        prefill_steps = 0
        while e.requests[r2].prefilling:
            e.step()
            prefill_steps += 1
            assert prefill_steps < 50, "verify lanes starved the prefill"
        assert len(e.requests[r1].out) - before >= prefill_steps
        out = e.run()
        runs.append([out[r1], out[r2]])
    assert runs[0] == runs[1]
    _same_run(eng, jeng)


def test_spec_rejects_bad_configs(params):
    from repro_torch.store import PageStore, StreamConfig

    def mk(**kw):
        return Engine(OPT_TINY, params, device="cpu", **kw)
    with pytest.raises(ValueError, match="compiled"):
        mk(compiled=False, spec_cfg=spec.SpecConfig(k=2))
    with pytest.raises(ValueError, match="compiled"):
        mk(compiled=False, spec_cfg=spec.SpecConfig(k=2),
           weight_store=PageStore(), stream_cfg=StreamConfig())
    with pytest.raises(ValueError, match="chunk_tokens"):
        mk(spec_cfg=spec.SpecConfig(k=8),
           admission_cfg=AdmissionConfig(chunk_tokens=8))
    with pytest.raises(ValueError, match="draft"):
        mk(spec_cfg=spec.SpecConfig(k=2, drafter="model"))
    with pytest.raises(ValueError, match="dense"):
        mk(spec_cfg=spec.SpecConfig(k=2, drafter="model"),
           draft_cfg=dataclasses.replace(OPT_TINY, family="moe"),
           draft_params=params)
    # the streamed plane runs eagerly by construction: the caller's
    # compiled=True is what the rule reads
    eng = mk(spec_cfg=spec.SpecConfig(k=2), weight_store=PageStore(),
             stream_cfg=StreamConfig())
    assert eng.step_traces == -1 and eng.spec_stats()["spec_drafted"] == 0
    with pytest.raises(ValueError, match="speculative"):
        mk().spec_stats()
    assert mk().spec_stats(strict=False) == {}


# --- adaptive per-slot k -----------------------------------------------------------

def test_adaptive_k_scales_draft_cap_with_ema(params):
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                 kv_aware=False, device="cpu",
                 spec_cfg=spec.SpecConfig(k=4, adaptive_k=True))
    rid = eng.submit([13] * 8, max_new=32)
    eng.step()                                    # prefill
    req = eng.requests[rid]
    for ema, want in ((1.0, 4), (0.5, 2), (0.0, 1)):   # probe lane floor
        eng._accept_ema[req.slot] = ema
        assert eng._draft_cap(req) == want
    eng2 = Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                  kv_aware=False, device="cpu",
                  spec_cfg=spec.SpecConfig(k=4))
    rid2 = eng2.submit([13] * 8, max_new=32)
    eng2.step()
    eng2._accept_ema[eng2.requests[rid2].slot] = 0.0
    assert eng2._draft_cap(eng2.requests[rid2]) == 4


def test_adaptive_k_shrinks_on_rejected_drafts(jax_params, params):
    """Drafts that never land drive the slot's EMA, and its verify lanes,
    to the probe floor; the tokens, the EMA and the per-slot k equal the
    JAX engine's, and the stream is plain greedy decoding."""
    kw = dict(name="draft", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
              d_ff=128)
    eng, jeng = _engines(jax_params, params,
                         spec_kw=dict(k=4, drafter="model", adaptive_k=True),
                         draft=_draft(9, **kw), max_slots=1)
    outs = []
    for e in (eng, jeng):
        rid = e.submit(list(range(1, 12)), max_new=20)
        outs.append(e.run()[rid])
    st = eng.spec_stats()
    assert min(st["spec_accept_ema"]) < 0.3
    assert st["spec_adaptive_k"][0] == 1
    _same_run(eng, jeng)
    ref = JEngine(J_OPT_TINY, jax_params, max_slots=1, max_seq=MAX_SEQ,
                  kv_aware=False, rber=0.0)
    r = ref.submit(list(range(1, 12)), max_new=20)
    assert outs[0] == outs[1] == ref.run()[r]


def test_adaptive_k_resets_ema_on_slot_reuse(params):
    eng = Engine(OPT_TINY, params, max_slots=1, max_seq=MAX_SEQ,
                 kv_aware=False, device="cpu",
                 spec_cfg=spec.SpecConfig(k=4, adaptive_k=True))
    eng.submit([13] * 8, max_new=4)
    eng.run()
    eng._accept_ema[:] = 0.0                      # pretend history cratered
    r2 = eng.submit([255] * 8, max_new=4)         # recycles the slot
    eng.step()
    assert eng._accept_ema[eng.requests[r2].slot] == 1.0
