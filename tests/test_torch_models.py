"""The port's model functions and the engine's data-plane pieces against the
JAX package on OPT_TINY: norms, rope, the attention-state merge, the GELU
FFN through the flash tier, one mixed-batch ``_chunk_layer`` and
``_finish_step``, and the sampler. Params come from the JAX init, carried
across with ``interop``; other inputs are made with numpy from a seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import scheduler as jsched
from repro.core import tiering as jtier
from repro.core.erdpe import ExecMode
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.serving import engine as jeng
from repro.serving import sampler as jsamp
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.core import scheduler as tsched
from repro_torch.core import tiering as ttier
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense
from repro_torch.serving import engine as teng
from repro_torch.serving import sampler as tsamp

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative (8 significant bits)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16(rng, *shape, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32)
                                  * scale).astype(jnp.bfloat16))


def test_norms_round_like_the_reference():
    """f32 inside, one rounding to bf16: the port and the reference may
    differ by the last bf16 bit where their f32 sums differ in order."""
    rng = np.random.default_rng(0)
    x, g, b = _bf16(rng, 6, 128, scale=3.0), _bf16(rng, 128), _bf16(rng, 128)
    for got, want in (
            (tcm.layer_norm(_t(x), _t(g), _t(b)), jcm.layer_norm(x, g, b)),
            (tcm.rms_norm(_t(x), _t(g)), jcm.rms_norm(x, g))):
        assert got.dtype == torch.bfloat16
        err = np.abs(_f(got) - _f(want))
        assert np.all(err <= BF16_ULP * np.abs(_f(want)) + 1e-6)


@pytest.mark.parametrize("name", ["OPT_TINY", "OPT_6_7B", "LLAMA2_7B"])
def test_attn_cfg_matches_reference(name):
    import dataclasses

    from repro.configs import paper_models
    from repro_torch import configs
    got = tdense.attn_cfg(getattr(configs, name))
    want = jdense.attn_cfg(getattr(paper_models, name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_layer_norm_is_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    y = tcm.layer_norm(x, torch.ones(4), torch.zeros(4))
    var = 1.25                                   # population, not 5/3
    want = (x - 2.5) / np.sqrt(var + 1e-5)
    torch.testing.assert_close(y, want)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32), np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    got = tcm.apply_rope(_t(x), _t(pos))
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(_f(got), _f(want), rtol=1e-5, atol=1e-5)


def test_merge_attn_states_matches_reference_with_empty_states():
    rng = np.random.default_rng(2)
    acc1, acc2 = (rng.standard_normal((3, 4, 8), np.float32) for _ in "12")
    m1 = np.array([[-np.inf, 0.5, 1.0, -np.inf]] * 3, np.float32)
    m2 = rng.standard_normal((3, 4), np.float32)
    l1 = np.where(np.isinf(m1), 0.0, 2.0).astype(np.float32)
    acc1[np.isinf(m1)] = 0.0
    l2 = np.full((3, 4), 1.5, np.float32)
    got = tcm.merge_attn_states(*map(_t, (acc1, m1, l1, acc2, m2, l2)))
    want = jcm.merge_attn_states(acc1, m1, l1, acc2, m2, l2)
    np.testing.assert_allclose(_f(got), _f(want), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """JAX init params of OPT_TINY, deployed by both packages (rber 1e-4),
    plus the per-layer Q/O flash copies."""
    p = jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))
    jt, _ = jtier.deploy(p, rber=1e-4, seed=0)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    tt, _ = ttier.deploy(tp, rber=1e-4, seed=0)
    j_fl = [{k: jtier.encode_flash(p["layers"]["attn"][k][li], rber=1e-4,
                                   seed=li) for k in ("wq", "wk", "wv", "wo")}
            for li in range(OPT_TINY.n_layers)]
    t_fl = [{k: ttier.encode_flash(tp["layers"]["attn"][k][li], rber=1e-4,
                                   seed=li) for k in ("wq", "wo")}
            for li in range(OPT_TINY.n_layers)]
    return jt, tt, j_fl, t_fl


def test_gelu_ffn_through_the_flash_tier(tiny):
    jt, tt, _, _ = tiny
    x = _bf16(np.random.default_rng(3), 2, 7, OPT_TINY.d_model)
    j_ffn = jax.tree.map(lambda a: a[1], jt["layers"]["ffn"])
    got = tdense._ffn_apply(OPT_TINY, teng._layer_slice(
        tt["layers"]["ffn"], 1), _t(x))
    want = jdense._ffn_apply(J_OPT_TINY, j_ffn, x)
    assert got.dtype == torch.bfloat16
    # GELU's tanh and the f32 sums may differ in the last f32 bits, which
    # can move a bf16 rounding of the hidden activation: one bf16 ulp of
    # the output, plus that ulp carried through w_down (abs 2e-2).
    np.testing.assert_allclose(_f(got), _f(want), rtol=BF16_ULP, atol=2e-2)


def _step_inputs(seed, n_slots=3, t=8):
    """A mixed batch: a slot mid-prefill with cached context, a fresh
    prefill and a decoding slot, over a scrambled layer pool."""
    cfg = OPT_TINY
    rng = np.random.default_rng(seed)
    bs, max_blocks = 16, 4
    n_blocks = 1 + n_slots * max_blocks
    lengths = np.array([5, 0, 17], np.int32)
    q_lens = np.array([8, 3, 1], np.int32)
    tables = np.zeros((n_slots, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    pi = 0
    for i in range(n_slots):
        for j in range(-(-(lengths[i] + q_lens[i]) // bs)):
            tables[i, j] = perm[pi]
            pi += 1
    pool_shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    return dict(
        x=_bf16(rng, n_slots, t, cfg.d_model),
        k=_bf16(rng, *pool_shape), v=_bf16(rng, *pool_shape),
        lengths=lengths, q_lens=q_lens, tables=tables,
        positions=(lengths[:, None] + np.arange(t)[None, :]).astype(np.int32),
        bitmap=np.array([1] * 22 + [0] * 10, np.int32),
        k_new=_bf16(rng, cfg.n_layers, n_slots, t, cfg.n_kv_heads,
                    cfg.head_dim),
        v_new=_bf16(rng, cfg.n_layers, n_slots, t, cfg.n_kv_heads,
                    cfg.head_dim),
        admitted=np.array([True, True, True]))


@pytest.mark.parametrize("mode", [ExecMode.XLA, ExecMode.PALLAS])
@pytest.mark.parametrize("li", [0, 3])
def test_chunk_layer_matches_reference(tiny, mode, li):
    """One layer of the mixed prefill/decode step, with the bitmap sending
    10 of 32 Q/O column groups to the flash copies."""
    jt, tt, j_fl, t_fl = tiny
    d = _step_inputs(li)
    ctx = np.where(d["q_lens"] > 0, d["lengths"], 0).astype(np.int32)
    j_layer = (jax.tree.map(lambda a: a[li], jt["layers"]), j_fl[li],
               d["k"][li], d["v"][li])
    jx, (jk, jv) = jeng._chunk_layer(
        J_OPT_TINY, mode, jnp.asarray(d["bitmap"]), jnp.asarray(ctx),
        jnp.asarray(d["positions"]), jnp.asarray(d["tables"]),
        jnp.asarray(d["x"]), j_layer)
    t_layer = (teng._layer_slice(tt["layers"], li), t_fl[li],
               _t(d["k"])[li], _t(d["v"])[li])
    tx, (tk, tv) = teng._chunk_layer(
        OPT_TINY, _t(d["bitmap"]), _t(ctx), _t(d["positions"]),
        _t(d["tables"]), _t(d["x"]), t_layer)
    if mode == ExecMode.XLA:
        # the same math and the same bf16 roundings: bit for bit on OPT_TINY
        for got, want in ((tx, jx), (tk, jk), (tv, jv)):
            np.testing.assert_array_equal(_f(got), _f(want))
    else:
        # the Pallas kernel rounds p to bf16 against its running max (the
        # plain version against the global one): a few attention outputs
        # land one bf16 ulp apart, which the residual add carries — at most
        # one bf16 ulp at the residual stream's largest magnitude per
        # element; K/V come before attention and stay exact
        np.testing.assert_array_equal(_f(tk), _f(jk))
        np.testing.assert_array_equal(_f(tv), _f(jv))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(_f(jx)).max())) - 7)
        np.testing.assert_allclose(_f(tx), _f(jx), rtol=0, atol=ulp)


def test_finish_step_matches_reference(tiny):
    jt, tt, _, _ = tiny
    d = _step_inputs(5)
    j_state = {"k": jnp.asarray(d["k"]), "v": jnp.asarray(d["v"]),
               "lengths": jnp.asarray(d["lengths"]),
               "bitmap": jnp.asarray(d["bitmap"]),
               "prev_cycles": jnp.int32(3)}
    sched_cfg = jsched.SchedulerConfig(column_bytes=OPT_TINY.d_model, h=32)
    j_toks, j_new, j_stats = jeng._finish_step(
        J_OPT_TINY, sched_cfg, jsamp.SampleConfig(), True, None,
        jt["final_norm"], jt["lm_head"], j_state, jnp.asarray(d["x"]),
        jnp.asarray(d["k_new"]), jnp.asarray(d["v_new"]),
        jnp.asarray(d["q_lens"]), jnp.asarray(d["admitted"]),
        jnp.asarray(d["positions"]), jnp.asarray(d["tables"]),
        jax.random.PRNGKey(0))
    t_state = {"k": _t(d["k"]), "v": _t(d["v"]),
               "lengths": _t(d["lengths"]), "bitmap": _t(d["bitmap"]),
               "prev_cycles": torch.tensor(3, dtype=torch.int32)}
    t_sched = tsched.SchedulerConfig(column_bytes=OPT_TINY.d_model, h=32)
    t_new = {k: t.clone() for k, t in t_state.items()}
    tensors = {k: id(t) for k, t in t_new.items()}
    t_toks, logits, t_stats = teng._finish_step(
        OPT_TINY, t_sched, tsamp.SampleConfig(), True, tt["final_norm"],
        tt["lm_head"], t_new, _t(d["x"]), _t(d["k_new"]), _t(d["v_new"]),
        _t(d["q_lens"]), _t(d["admitted"]), _t(d["positions"]),
        _t(d["tables"]), None)
    # the port writes the state in place: the same tensors, new values
    assert {k: id(t) for k, t in t_new.items()} == tensors
    # the KV write: identical rows everywhere but the dump block 0 (where
    # padding lanes collide and either write may land)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_f(t_new[key])[:, 1:],
                                      _f(j_new[key])[:, 1:])
    for key in ("lengths", "bitmap", "prev_cycles"):
        np.testing.assert_array_equal(t_new[key].numpy(),
                                      np.asarray(j_new[key]))
    for i, key in enumerate(("kv_len", "delta_cycles", "npu_fraction")):
        assert float(t_stats[i]) == float(j_stats[key]), key
    # logits: the reference's lm_head at the last valid lanes
    x_last = jsamp.last_valid_hidden(
        jcm.layer_norm(jnp.asarray(d["x"]), jt["final_norm"]["g"],
                       jt["final_norm"]["b"]), jnp.asarray(d["q_lens"]))
    from repro.core.erdpe import flash_matmul
    j_logits = np.asarray(flash_matmul(x_last, jt["lm_head"],
                                       out_dtype=jnp.float32))
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=1e-5,
                               atol=1e-4)
    top2 = np.sort(j_logits, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)   # no near-tie here
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))


def test_sampler_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, 8), np.float32)
    q_lens = np.array([6, 1, 0, 3], np.int32)
    np.testing.assert_array_equal(
        tsamp.last_valid_hidden(_t(x), _t(q_lens)).numpy(),
        np.asarray(jsamp.last_valid_hidden(x, q_lens)))
    logits = rng.standard_normal((4, 50), np.float32)
    greedy = tsamp.SampleConfig()
    np.testing.assert_array_equal(
        tsamp.sample(_t(logits), None, greedy).numpy(),
        np.asarray(jsamp.sample(logits, jax.random.PRNGKey(0),
                                jsamp.SampleConfig())))
    for top_k, top_p in ((5, 1.0), (0, 0.7), (10, 0.5)):
        got = tsamp.filter_logits(_t(logits), tsamp.SampleConfig(
            temperature=0.8, top_k=top_k, top_p=top_p))
        want = jsamp.filter_logits(logits, jsamp.SampleConfig(
            temperature=0.8, top_k=top_k, top_p=top_p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # top-p that the f32 cumulative softmax never reaches keeps the whole
    # vocabulary (the reference's take past the end masks nothing)
    flat = rng.normal(0.0, 0.01, (10, 50272)).astype(np.float32)
    for top_p in (0.9999999, 1 - 1e-9):
        got = tsamp.filter_logits(_t(flat), tsamp.SampleConfig(
            temperature=1.0, top_p=top_p))
        want = jsamp.filter_logits(flat, jsamp.SampleConfig(
            temperature=1.0, top_p=top_p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # temperature > 0 draws only from the kept set, from the generator
    g = torch.Generator().manual_seed(0)
    cfg = tsamp.SampleConfig(temperature=0.8, top_k=3)
    draws = tsamp.sample(_t(logits), g, cfg)
    kept = np.argsort(logits, axis=-1)[:, -3:]
    assert all(int(d) in kept[i] for i, d in enumerate(draws))
