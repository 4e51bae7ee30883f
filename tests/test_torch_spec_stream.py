"""Speculative decoding on the port's streamed plane and through the
serving front, against the JAX package: the streamed spec engine
(``weight_store=PageStore()``) emits the JAX streamed spec engine's greedy
tokens with the same spec keys in ``stream_stats``, and step by step the
port's resident spec engine's logits and verify-lane logits bit for bit,
streaming the vanilla streamed engine's windows per step; the spec
samples' exposition is byte-equal to the reference's; ``ServeFront``'s
``/v1/stats`` nests ``spec`` as the reference's front does. Params are
carried across from ``dense.init(OPT_TINY, PRNGKey(0))``; the prompts are
tests/test_torch_spec.py's margin-scanned ones."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.models import dense as jdense
from repro.serving import spec as jspec
from repro.serving.engine import Engine as JEngine
from repro.serving.server import ServeFront as JServeFront
from repro.store import PageStore as JPageStore
from repro.store import StreamConfig as JStreamConfig
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.configs import OPT_TINY
from repro_torch.core.scheduler import AdmissionConfig
from repro_torch.kernels import ecdp, paged_attn, paged_ecdp
from repro_torch.serving import spec
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import ServeFront
from repro_torch.store import PageStore, StreamConfig

torch.set_num_threads(2)

MAX_SEQ = 96
PROMPTS = [[28] * 8, [88] * 8, [175] * 8]      # tests/test_torch_spec.py's
SPEC_KEYS = ("spec_verify_steps", "spec_drafted", "spec_accepted",
             "spec_emitted", "spec_acceptance_rate", "spec_tokens_per_step")


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def _serve(eng):
    rids = [eng.submit(list(p), max_new=16) for p in PROMPTS]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def streamed_pair(jax_params, params):
    """The JAX and the port's streamed spec engines (group_size=1, k=4,
    kv_aware=False) after serving PROMPTS, and the JAX vanilla tokens."""
    kw = dict(max_slots=3, max_seq=MAX_SEQ, rber=0.0, kv_aware=False)
    jeng = JEngine(J_OPT_TINY, jax_params, weight_store=JPageStore(),
                   stream_cfg=JStreamConfig(group_size=1),
                   spec_cfg=jspec.SpecConfig(k=4), **kw)
    eng = Engine(OPT_TINY, params, weight_store=PageStore(),
                 stream_cfg=StreamConfig(group_size=1),
                 spec_cfg=spec.SpecConfig(k=4), device="cpu", **kw)
    greedy = _serve(JEngine(J_OPT_TINY, jax_params, **kw))
    return (eng, _serve(eng)), (jeng, _serve(jeng)), greedy


def test_streamed_spec_matches_the_reference(streamed_pair):
    (eng, out), (jeng, jout), greedy = streamed_pair
    assert out == jout == greedy

    def planned(e):                    # stall_frac is host timing
        return [{k: v for k, v in s.items() if k != "stall_frac"}
                for s in e.stats]
    assert planned(eng) == planned(jeng)
    st, jst = eng.stream_stats(), jeng.stream_stats()
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_accepted"] > 0 and st["bytes_streamed"] > 0
    # one weight stream a step, amortised over > 1 token
    assert st["spec_verify_steps"] < sum(len(o) for o in out)
    assert eng.step_traces == -1


def _budgeted(params, spec_cfg=None):
    """A streamed engine whose device budget holds lm_head and the two
    windows in flight: every step streams every layer group."""
    kw = dict(max_slots=3, max_seq=MAX_SEQ, rber=1e-4, seed=1, kv_aware=False,
              device="cpu", admission_cfg=AdmissionConfig(token_budget=512))
    probe = Engine(OPT_TINY, params, weight_store=PageStore(), **kw)
    budget = (probe.store.entry_nbytes("lm_head") + 2 * probe._group_bytes)
    cfg = StreamConfig(group_size=1, prefetch_depth=2, pin_edges=False,
                       device_budget_bytes=budget)
    return Engine(OPT_TINY, params, weight_store=PageStore(n_planes=8),
                  stream_cfg=cfg, spec_cfg=spec_cfg, **kw), kw


def test_streamed_spec_equals_the_resident_spec_engine_each_step(params):
    """Streamed spec vs resident spec in lockstep at RBER 1e-4: the same
    bytes and the same math, so the same logits and verify-lane logits bit
    for bit and the same tokens; every step streams as many windows as the
    vanilla streamed engine's steps do; no kernel launches on the CPU."""
    stm, kw = _budgeted(params, spec.SpecConfig(k=4))
    res = Engine(OPT_TINY, params, spec_cfg=spec.SpecConfig(k=4), **kw)
    before = (ecdp.ecdp_matmul.launches, paged_ecdp.paged_ecdp_matmul.launches,
              paged_attn.paged_attn.launches)
    for e in (res, stm):
        for p in PROMPTS:
            e.submit(list(p), max_new=16)
    steps = 0
    while True:
        n_res, n_stm = res.step(), stm.step()
        assert n_res == n_stm
        if n_res == 0:
            break
        assert torch.equal(res.last_logits, stm.last_logits), steps
        assert torch.equal(res.last_lane_logits, stm.last_lane_logits), steps
        steps += 1
    assert [r.out for r in res.requests.values()] == \
        [r.out for r in stm.requests.values()]
    assert res.stats == [{k: v for k, v in s.items() if k != "stall_frac"}
                         for s in stm.stats]
    assert (ecdp.ecdp_matmul.launches, paged_ecdp.paged_ecdp_matmul.launches,
            paged_attn.paged_attn.launches) == before
    van, _ = _budgeted(params)
    _serve(van)
    per_step = {e: e.stream_stats()["groups_streamed"] / len(e.stats)
                for e in (stm, van)}
    assert per_step[stm] == per_step[van] == OPT_TINY.n_layers
    st = stm.spec_stats()
    assert st["spec_verify_steps"] < st["spec_emitted"]
    assert len(stm.stats) < len(van.stats)


def _spec_exposition(o, samples) -> str:
    reg = o.MetricsRegistry()
    reg.register_collector(lambda: list(samples))
    return reg.expose()


def test_spec_exposition_equals_the_reference(streamed_pair):
    """The engines' spec samples after the same run, and a fixed totals
    dict, exposed by each package's registry: byte-equal text."""
    (eng, _), (jeng, _), _ = streamed_pair

    def spec_samples(e):
        return [s for s in e.obs_samples() if s.name.startswith("spec_")]
    got = _spec_exposition(tobs, spec_samples(eng))
    want = _spec_exposition(jobs, spec_samples(jeng))
    assert got == want
    assert "# TYPE spec_acceptance_rate gauge" in got
    assert "spec_verify_steps_total %d\n" % \
        eng.spec_stats()["spec_verify_steps"] in got
    totals = {"verify_steps": 7, "drafted": 19, "accepted": 11,
              "emitted": 25}
    assert _spec_exposition(tobs, spec.spec_obs_samples(totals)) == \
        _spec_exposition(jobs, jspec.spec_obs_samples(totals))


def test_front_stats_nest_spec(jax_params, params):
    """``/v1/stats`` (``ServeFront.stats``) of a spec engine carries the
    engine's ``spec_stats`` under ``spec``, as the reference's front does
    over the JAX spec engine; a vanilla engine's carries none."""
    kw = dict(max_slots=3, max_seq=MAX_SEQ, rber=0.0, kv_aware=False)
    fronts = (ServeFront(Engine(OPT_TINY, params, device="cpu",
                                spec_cfg=spec.SpecConfig(k=4), **kw)),
              JServeFront(JEngine(J_OPT_TINY, jax_params,
                                  spec_cfg=jspec.SpecConfig(k=4), **kw)))
    outs, stats = [], []
    for front in fronts:
        with front.engine._cv:         # one batch: both fronts plan alike
            hs = [front.add_request(list(p), max_new=16) for p in PROMPTS]
        outs.append([h.result(timeout=300) for h in hs])
        front.close()
        stats.append(front.stats())
    assert outs[0] == outs[1]
    assert stats[0]["spec"] == fronts[0].engine.spec_stats()
    assert stats[0]["spec"] == stats[1]["spec"]
    assert stats[0]["spec"]["spec_accepted"] > 0
    plain = ServeFront(Engine(OPT_TINY, params, device="cpu", **kw))
    plain.add_request([28] * 8, max_new=2).result(timeout=60)
    plain.close()
    assert "spec" not in plain.stats()
