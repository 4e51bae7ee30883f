"""The port's compiled steps on the CPU, where PyTorch has no CUDA graphs:
``Engine(compiled=True)`` runs the static-buffer step body without
capture, ``make_decode_step(compiled=True)`` its body eagerly. What the
capture on the card relies on is checked here: compiled and eager agree
bit for bit, the idle warm-up batch touches nothing but the dump block,
the static inputs and the state keep their addresses, and the bodies read
no tensor on the host. The card's captures are tests/test_torch_gpu.py's.
OPT_TINY with the port's own seeded init; prompts as in
tests/test_engine_jit.py."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import OPT_TINY
from repro_torch.core.tiering import deploy
from repro_torch.launch import steps
from repro_torch.models import dense
from repro_torch.serving.engine import Engine
from repro_torch.store import PageStore

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return dense.init(OPT_TINY, torch.Generator().manual_seed(0),
                      device="cpu")


def _engine(params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 96)
    return Engine(OPT_TINY, params, rber=1e-4, seed=1, device="cpu", **kw)


def _run(eng, logits):
    while eng.step():
        logits.append(eng.last_logits.clone())


def _slot_churn(eng, logits):
    r1 = eng.submit([1, 2, 3], max_new=2)
    r2 = eng.submit([5, 6, 7, 8, 9], max_new=12)
    while not eng.requests[r1].done:
        eng.step()
        logits.append(eng.last_logits.clone())
    r3 = eng.submit([2, 2], max_new=4)          # into r1's released slot
    _run(eng, logits)
    return [r1, r2, r3]


def _realloc(eng, logits):
    """A long prompt in chunks beside a released and re-allocated slot."""
    r1 = eng.submit([4, 4, 4], max_new=2)
    r2 = eng.submit(list(range(1, 30)), max_new=9)
    while not eng.requests[r1].done:
        eng.step()
        logits.append(eng.last_logits.clone())
    r3 = eng.submit([2, 2], max_new=4)
    _run(eng, logits)
    return [r1, r2, r3]


@pytest.mark.parametrize("scenario", [_slot_churn, _realloc],
                         ids=["slot_churn", "realloc"])
def test_compiled_and_eager_engines_agree_bit_for_bit(params, scenario):
    runs = {}
    for compiled in (True, False):
        eng = _engine(params, compiled=compiled)
        logits = []
        rids = scenario(eng, logits)
        runs[compiled] = ([eng.requests[r].out for r in rids], logits,
                          eng.stats, eng.step_traces)
    assert runs[True][3] == 0 and runs[False][3] == -1   # no graphs here
    assert runs[True][0] == runs[False][0]
    assert runs[True][2] == runs[False][2]
    assert len(runs[True][1]) == len(runs[False][1]) > 0
    for got, want in zip(runs[True][1], runs[False][1]):
        assert torch.equal(got, want)


def test_idle_batch_writes_only_the_dump_block(params):
    """The batch the card warms up and captures on (every q_lens 0, every
    admitted False), run mid-stream: lengths, bitmap, prev_cycles and every
    pool block but the dump block 0 stay as they were."""
    eng = _engine(params, admission_cfg=None)
    eng.submit(list(range(1, 40)), max_new=30)
    eng.submit([7, 3], max_new=30)
    for _ in range(12):
        eng.step()
    assert eng.pool.lengths.min() > 0
    before = {k: t.clone() for k, t in eng._state().items()}
    for t in eng._dev_in.values():
        t.zero_()
    with torch.no_grad():
        eng._resident_body()
    after = eng._state()
    for k in ("lengths", "bitmap", "prev_cycles"):
        assert torch.equal(after[k], before[k]), k
    for k in ("k", "v"):
        assert torch.equal(after[k][:, 1:], before[k][:, 1:]), k
    # and the stream carries on as if nothing ran
    assert eng.step() > 0


def test_static_inputs_and_state_keep_their_addresses(params):
    eng = _engine(params)

    def ptrs():
        return ({k: t.data_ptr() for k, t in eng._dev_in.items()},
                {k: t.data_ptr() for k, t in eng._host_in.items()},
                {k: t.data_ptr() for k, t in eng._state().items()})
    first = ptrs()
    _slot_churn(eng, [])
    assert ptrs() == first


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every way a tensor's values reach the host raises."""
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return fn
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__int__", "__float__",
                     "__index__", "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield


def test_step_bodies_read_no_tensor_on_the_host(params, monkeypatch):
    """What the capture on the card needs: the resident step body and the
    offline decode body make no host read (the card's warm-up also runs
    under torch.cuda.set_sync_debug_mode("error"))."""
    eng = _engine(params)
    eng.submit(list(range(1, 20)), max_new=4)
    eng.submit([5, 6], max_new=4)
    eng.step()                                   # a prefill and a decode
    eng.step()
    eng._load_inputs()
    p, _ = deploy(params, rber=1e-4, seed=1)
    toks = torch.ones((2, 5), dtype=torch.int32)
    last, cache = dense.prefill(OPT_TINY, p, {"tokens": toks}, pad_to=12)
    tok, pos = last.argmax(-1), torch.full((1,), 5, dtype=torch.int64)
    with torch.no_grad(), _no_host_reads(monkeypatch):
        with pytest.raises(AssertionError, match="host read"):
            torch.ones(2).sum().item()           # the patch bites
        eng._resident_body()
        dense.decode_body(OPT_TINY, p, cache, tok, pos)


def test_compiled_decode_step_equals_eager_bit_for_bit(params):
    p, _ = deploy(params, rber=1e-4, seed=1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, OPT_TINY.vocab_size, (3, 9))).int()
    prefill = steps.make_prefill_step(OPT_TINY, pad_to=16)
    eager = steps.make_decode_step(OPT_TINY)
    compiled = steps.make_decode_step(OPT_TINY, compiled=True)
    last, c_e = prefill(p, {"tokens": toks})
    _, c_c = prefill(p, {"tokens": toks})
    tok = last.argmax(-1)
    for i in range(5):
        lg_e, c_e = eager(p, c_e, {"token": tok, "kv_len": 9 + i})
        lg_c, c_c2 = compiled(p, c_c, {"token": tok, "kv_len": 9 + i})
        assert c_c2 is c_c                           # written in place
        assert torch.equal(lg_c, lg_e)
        tok = lg_e.argmax(-1)
    for k in ("k", "v"):
        assert torch.equal(c_c[k], c_e[k])
    assert compiled.captures == 0                    # nothing to capture here
    before = c_c["k"].clone()
    for kv_len in (16, -1):
        with pytest.raises(ValueError, match="outside"):
            compiled(p, c_c, {"token": tok, "kv_len": kv_len})
    assert torch.equal(c_c["k"], before)


def test_f32_dram_weights_give_the_bf16_upcast_logits(params):
    """The resident engine keeps wq/wk/wv/wo in f32, made once: the same
    logits as the bf16 weights upcast at every step (bf16 -> f32 is
    exact)."""
    engs = [_engine(params), _engine(params)]
    attn = engs[1].params["layers"]["attn"]
    for k in ("wq", "wk", "wv", "wo"):
        assert engs[0].params["layers"]["attn"][k].dtype == torch.float32
        assert torch.equal(engs[0].params["layers"]["attn"][k],
                           params["layers"]["attn"][k].float())
        attn[k] = attn[k].to(torch.bfloat16)
    engs[1]._layers = [dense.layer_slice(engs[1].params["layers"], li)
                       for li in range(OPT_TINY.n_layers)]
    logits = [[], []]
    for eng, out in zip(engs, logits):
        eng.submit(list(range(1, 25)), max_new=5)
        eng.submit([9, 8], max_new=5)
        _run(eng, out)
    assert len(logits[0]) == len(logits[1]) > 0
    for a, b in zip(*logits):
        assert torch.equal(a, b)


def test_streamed_engine_stays_eager_with_bf16_weights(params):
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=96,
                 weight_store=PageStore(), device="cpu")
    assert not eng.compiled and eng.step_traces == -1
    assert eng._layers[0]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_spec_step_body_reads_no_tensor_on_the_host(params, monkeypatch,
                                                    drafter, temperature):
    """The speculative step body (drafter, verify lanes, rejection
    sampling, the length rewind) makes no host read either, so the card
    captures it; its static inputs keep their addresses through a run."""
    from repro_torch.serving.sampler import SampleConfig
    from repro_torch.serving.spec import SpecConfig

    kw = {}
    if drafter == "model":
        dcfg = dataclasses.replace(OPT_TINY, name="draft", n_layers=1,
                                   d_model=64, n_heads=2, n_kv_heads=2,
                                   head_dim=32, d_ff=128)
        kw = dict(draft_cfg=dcfg, draft_params=dense.init(
            dcfg, torch.Generator().manual_seed(5), device="cpu"))
    eng = _engine(params, spec_cfg=SpecConfig(k=3, drafter=drafter),
                  sample_cfg=SampleConfig(temperature=temperature, top_k=40),
                  **kw)
    ptrs = {k: t.data_ptr() for k, t in eng._dev_in.items()}
    assert {"hist", "hist_lens", "draft_cap", "is_decode"} <= set(ptrs)
    eng.submit([7, 7, 7, 7, 7, 7], max_new=12)
    eng.submit([5, 6], max_new=12)
    eng.step()                                   # prefills
    eng.step()                                   # a verify step
    eng._load_inputs()
    assert eng._dev_in["is_decode"].all()
    with torch.no_grad(), _no_host_reads(monkeypatch):
        toks, n_emit, logits, lane_logits, stats = eng._resident_body()
    assert toks.shape == (2, 4) and lane_logits.shape[:2] == (2, 4)
    assert stats.shape == (6 + 2 * 2,)
    eng.run()
    assert [len(r.out) for r in eng.requests.values()] == [12, 12]
    assert {k: t.data_ptr() for k, t in eng._dev_in.items()} == ptrs


def _masked_grouped_plain(a, row_start, wq, parity, scale,
                          ecc_enabled=True):
    """The grouped ECDP's plain version with its row ranges applied as
    masks on the device instead of read on the host."""
    from repro_torch.kernels.ecdp import ecdp_matmul_plain
    rows = torch.arange(a.shape[0])[:, None]
    out = torch.zeros((a.shape[0], wq.shape[2]))
    for e in range(wq.shape[0]):
        inside = (rows >= row_start[e]) & (rows < row_start[e + 1])
        out = torch.where(inside, ecdp_matmul_plain(
            a, wq[e], parity[e], scale[e], ecc_enabled), out)
    return out


def test_moe_step_bodies_read_no_tensor_on_the_host(monkeypatch):
    """The resident MoE step body (router, the sorted dispatch, the grouped
    bank products, the combine) and the MoE offline decode body (the
    capacity dispatch) make no host read, so the card captures them. The
    grouped ECDP's plain version reads its row ranges on the host (on the
    card the wrapper hands them to the kernel as a device pointer); here a
    stand-in that masks instead replaces it, and gives the same logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_ecdp
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    p = moe.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, p, max_slots=2, max_seq=96, rber=1e-3, device="cpu")
    eng.submit(list(range(1, 20)), max_new=4)
    eng.submit([5, 6], max_new=4)
    eng.step()                                   # a prefill chunk each
    eng.step()                                   # a prefill and a decode
    eng._load_inputs()
    state = {k: t.clone() for k, t in eng._state().items()}
    want = eng._resident_body()[1]
    for k, t in eng._state().items():            # the step writes in place
        t.copy_(state[k])
    d, _ = deploy(p, rber=1e-3, seed=1)
    last, cache = moe.prefill(cfg, d, {"tokens": torch.ones(
        (2, 5), dtype=torch.int32)}, pad_to=12)
    tok, pos = last.argmax(-1), torch.full((1,), 5, dtype=torch.int64)
    monkeypatch.setattr(grouped_ecdp, "grouped_ecdp_plain",
                        _masked_grouped_plain)
    with torch.no_grad(), _no_host_reads(monkeypatch):
        got = eng._resident_body()[1]
        moe.decode_body(cfg, d, cache, tok, pos)
    assert torch.equal(got, want)
