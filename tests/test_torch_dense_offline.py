"""The dense family's offline inference path in the port against the JAX
package: ``chunked_attention``, ``qkv_project``, ``forward``, ``prefill``
with ``pad_to``, ``cache_shape``, greedy ``decode_step``s on OPT_TINY (bf16
params, and the flash tier deployed at RBER 0 and 1e-4), teacher-forced
decode against the port's own forward on the granite-8b smoke config (GQA,
RoPE, RMSNorm, SwiGLU), the step builders, and the cache-bound check.
Params come from the JAX init, carried across with ``interop``; prompts and
other inputs are made with numpy from a seed."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.core import tiering as jtier
from repro.models import common as jcm
from repro.models import dense as jdense
from repro_torch import interop
from repro_torch.configs import OPT_TINY, ArchConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense
from repro_torch.models import family_module

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative (8 significant bits)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mk(rng, shape, dtype):
    return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32)
                                  ).astype(dtype))


# --- chunked attention ---------------------------------------------------------

CHUNKED = [  # sq, skv, h, n_kv, q_offset, window, kv_block
    (24, 24, 4, 4, 0, None, 8),        # causal prefill, MHA
    (24, 40, 4, 2, 16, None, 16),      # q_offset: a chunk after 16 cached rows
    (24, 24, 8, 2, 0, 5, 8),           # windowed
    (40, 40, 4, 1, 0, None, 16),       # kv_block does not divide S (MQA)
    (12, 40, 4, 2, 28, 9, 1024),       # one block past S, window + offset
]


@pytest.mark.parametrize("case", CHUNKED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(case, dtype):
    """Same online softmax over KV blocks: f32 sums in another order. f32
    inputs within 1e-5; bf16 outputs are rounded once from f32, so within
    one bf16 ulp of each value."""
    sq, skv, h, n_kv, q_offset, window, kv_block = case
    rng = np.random.default_rng(sq * skv + h)
    q = _mk(rng, (2, sq, h, 16), dtype)
    k, v = _mk(rng, (2, skv, n_kv, 16), dtype), _mk(rng, (2, skv, n_kv, 16),
                                                     dtype)
    got = tcm.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                q_offset=q_offset, window=window,
                                kv_block=kv_block)
    want = jcm.chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                                 window=window, kv_block=kv_block)
    assert got.dtype == _t(q).dtype and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(_f(got), _f(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_f(got), _f(want), rtol=BF16_ULP,
                                   atol=1e-6)


def test_chunked_attention_non_causal_matches_reference():
    rng = np.random.default_rng(3)
    q, k, v = (_mk(rng, s, "float32") for s in ((1, 9, 4, 8), (1, 21, 2, 8),
                                                 (1, 21, 2, 8)))
    got = tcm.chunked_attention(_t(q), _t(k), _t(v), causal=False,
                                kv_block=8)
    want = jcm.chunked_attention(q, k, v, causal=False, kv_block=8)
    np.testing.assert_allclose(_f(got), _f(want), rtol=1e-5, atol=1e-5)


# --- qkv_project ---------------------------------------------------------------

@pytest.mark.parametrize("qk_norm,use_rope", [(False, False), (True, True)])
def test_qkv_project_matches_reference(qk_norm, use_rope):
    """bf16 projections (one rounding from f32), rms qk-norm and RoPE in
    f32, rounded to bf16: each value within one bf16 ulp."""
    jcfg = jcm.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          qk_norm=qk_norm, use_rope=use_rope)
    tcfg = tcm.AttnConfig(**dataclasses.asdict(jcfg))
    p = jcm.attn_init(jax.random.PRNGKey(1), jcfg)
    if qk_norm:
        p = dict(p, q_norm=p["q_norm"] + 0.25, k_norm=p["k_norm"] - 0.5)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    x = _mk(np.random.default_rng(2), (2, 7, 64), jnp.bfloat16)
    pos = np.arange(5, 12)
    got = tcm.qkv_project(tp, _t(x), tcfg, torch.from_numpy(pos))
    want = jcm.qkv_project(p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_f(g), _f(w), rtol=BF16_ULP, atol=1e-6)


# --- OPT_TINY: forward, prefill, greedy decode -----------------------------------

# Logits of the two packages: bf16 activations whose f32 sums run in
# another order round one ulp apart now and then, and four random-init
# layers amplify those flips; the largest difference seen over these
# prompts is 1.1e-2 of the row's largest |logit|. Bound: 2^-5 of it.
LOGIT_REL_TOL = 2.0 ** -5
# The prompts are margin-scanned: every greedy step of the JAX run keeps
# its top-2 logit margin above this (about twice the largest absolute
# logit difference seen, 0.025), so a greedy token cannot flip on a
# near-tie (ROADMAP C).
MIN_MARGIN = 0.04
N_DECODE = 4
PROMPT_SEED, PROMPT_SHAPE, PAD_TO = 0, (2, 8), 16


@functools.lru_cache(maxsize=None)
def _jax_opt_tiny():
    params = jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))
    prefill = jax.jit(functools.partial(jdense.prefill, J_OPT_TINY),
                      static_argnames=("pad_to",))
    decode = jax.jit(functools.partial(jdense.decode_step, J_OPT_TINY))
    return params, prefill, decode


def _tiers(tier):
    """(JAX params, port params) of OPT_TINY: bf16, or deployed."""
    params, _, _ = _jax_opt_tiny()
    if tier == "bf16":
        return params, interop.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu")
    deployed, _ = jtier.deploy(params, rber=tier, seed=0)
    return deployed, interop.deployed_from_numpy(
        jax.tree.map(np.asarray, deployed), device="cpu")


def _assert_rel_close(got, want, what):
    """|got - want| <= LOGIT_REL_TOL x the largest |want| of its last axis
    (a row of logits; a cache row of one head)."""
    want = np.asarray(want, np.float32)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(np.asarray(got) - want)
    assert np.all(err <= LOGIT_REL_TOL * row_max), \
        (what, float((err / np.maximum(row_max, 1e-30)).max()))


def _assert_logits_close(got, want, what):
    _assert_rel_close(got.numpy(), want, what)


@pytest.mark.parametrize("tier", ["bf16", 0.0, 1e-4])
def test_prefill_and_greedy_decode_match_reference(tier):
    jp, tp = _tiers(tier)
    _, jprefill, jdecode = _jax_opt_tiny()
    toks = np.random.default_rng(PROMPT_SEED).integers(
        0, OPT_TINY.vocab_size, PROMPT_SHAPE).astype(np.int32)
    j_last, j_cache = jprefill(jp, {"tokens": jnp.asarray(toks)},
                               pad_to=PAD_TO)
    t_last, t_cache = tdense.prefill(OPT_TINY, tp,
                                     {"tokens": torch.from_numpy(toks)},
                                     pad_to=PAD_TO)
    shape = tdense.cache_shape(OPT_TINY, *PROMPT_SHAPE[:1], PAD_TO)
    want_shape = jdense.cache_shape(J_OPT_TINY, PROMPT_SHAPE[0], PAD_TO)
    for name in ("k", "v"):
        assert tuple(t_cache[name].shape) == tuple(shape[name].shape) \
            == want_shape[name].shape
        assert t_cache[name].dtype == shape[name].dtype == torch.bfloat16
        # the prompt's rows as the logits (the same flips), padding zero
        _assert_rel_close(_f(t_cache[name]), _f(j_cache[name]), name)
        assert not t_cache[name][:, :, PROMPT_SHAPE[1]:].any()
    _assert_logits_close(t_last, j_last, "prefill")
    j_tok = t_tok = None
    for step in range(N_DECODE + 1):
        if step:
            kv_len = PROMPT_SHAPE[1] + step - 1
            j_last, j_cache = jdecode(jp, j_cache, {
                "token": jnp.asarray(j_tok), "kv_len": jnp.int32(kv_len)})
            t_last, t_cache = tdense.decode_step(OPT_TINY, tp, t_cache, {
                "token": torch.from_numpy(t_tok), "kv_len": kv_len})
            _assert_logits_close(t_last, j_last, f"decode step {step}")
        top2 = np.sort(np.asarray(j_last), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > MIN_MARGIN, \
            "the prompt is not margin-safe"
        j_tok = np.asarray(jnp.argmax(j_last, -1), np.int32)
        t_tok = t_last.argmax(-1).int().numpy()
        np.testing.assert_array_equal(t_tok, j_tok)
    # the cache rows the decode steps wrote
    for name in ("k", "v"):
        _assert_rel_close(_f(t_cache[name]), _f(j_cache[name]), name)


def test_forward_matches_reference_and_prefill_keeps_the_last_row():
    jp, tp = _tiers("bf16")
    toks = np.random.default_rng(PROMPT_SEED).integers(
        0, OPT_TINY.vocab_size, PROMPT_SHAPE).astype(np.int32)
    got = tdense.forward(OPT_TINY, tp, torch.from_numpy(toks))
    want = jdense.forward(J_OPT_TINY, jp, jnp.asarray(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    for t in range(PROMPT_SHAPE[1]):
        _assert_logits_close(got[:, t], want[:, t], f"position {t}")
    last, cache = tdense.prefill(OPT_TINY, tp,
                                 {"tokens": torch.from_numpy(toks)})
    assert torch.equal(last, got[:, -1])
    assert cache["k"].shape[2] == PROMPT_SHAPE[1]          # no pad_to
    with pytest.raises(ValueError):
        tdense.prefill(OPT_TINY, tp, {"tokens": torch.from_numpy(toks)},
                       pad_to=4)


def test_prefill_with_patch_embeds_matches_reference():
    """The VLM stub frontend: patch embeddings prepended to the token
    embeddings; positions count them, the cache holds them."""
    jp, tp = _tiers("bf16")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, OPT_TINY.vocab_size, (2, 6)).astype(np.int32)
    patches = _mk(rng, (2, 3, OPT_TINY.d_model), jnp.bfloat16)
    got_last, got_cache = tdense.prefill(
        OPT_TINY, tp, {"tokens": torch.from_numpy(toks),
                       "patch_embeds": _t(patches)}, pad_to=12)
    want_last, want_cache = jdense.prefill(
        J_OPT_TINY, jp, {"tokens": jnp.asarray(toks),
                         "patch_embeds": jnp.asarray(patches)}, pad_to=12)
    assert tuple(got_cache["k"].shape) == want_cache["k"].shape
    _assert_logits_close(got_last, want_last, "prefill with patches")
    _assert_rel_close(_f(got_cache["k"]), _f(want_cache["k"]), "k")


# --- teacher-forced decode == forward (granite smoke: GQA, RoPE, RMSNorm) ----

def test_teacher_forced_decode_matches_forward_gqa_rope_swiglu():
    """The JAX test_models.py check on the port: prefill the first 6
    tokens, decode the rest teacher-forced; each step's logits equal the
    full forward's at that position (the JAX file's tolerances: decode's
    p is rounded to bf16, forward's chunked attention keeps it f32)."""
    jcfg = get_config("granite-8b", smoke=True)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, jdense.init(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    logits = tdense.forward(cfg, params, toks)
    last, cache = tdense.prefill(cfg, params, {"tokens": toks[:, :6]},
                                 pad_to=16)
    torch.testing.assert_close(last, logits[:, 5], rtol=2e-2, atol=2e-2)
    for t in range(6, 12):
        lg, cache2 = tdense.decode_step(cfg, params, cache,
                                        {"token": toks[:, t], "kv_len": t})
        assert cache2 is cache                       # written in place
        torch.testing.assert_close(lg, logits[:, t], rtol=5e-2, atol=5e-2)


# --- step builders, family dispatch, cache bound -----------------------------

def test_step_builders_call_the_family_functions():
    _, tp = _tiers("bf16")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, OPT_TINY.vocab_size, (2, 5)).astype(np.int32))
    last, cache = tsteps.make_prefill_step(OPT_TINY, pad_to=8)(
        tp, {"tokens": toks})
    want_last, want_cache = tdense.prefill(OPT_TINY, tp, {"tokens": toks},
                                           pad_to=8)
    assert torch.equal(last, want_last)
    assert torch.equal(cache["k"], want_cache["k"])
    batch = {"token": last.argmax(-1), "kv_len": 5}
    lg, _ = tsteps.make_decode_step(OPT_TINY)(tp, cache, batch)
    want, _ = tdense.decode_step(OPT_TINY, tp, want_cache, batch)
    assert torch.equal(lg, want)
    assert family_module("dense") is tdense
    for family in ("dense", "moe", "rwkv6", "rglru", "encdec"):
        mod = family_module(family)
        assert mod.__name__ == f"repro_torch.models.{family}"
        for fn in ("init", "prefill", "decode_step", "decode_check",
                   "decode_body", "cache_shape"):
            assert callable(getattr(mod, fn)), (family, fn)
    with pytest.raises(KeyError):
        family_module("no-such-family")


@pytest.mark.parametrize("kv_len", [16, 17, -1])
def test_decode_step_raises_outside_the_cache(kv_len):
    """The reference's dynamic_update_slice clamps a start past the cache
    and overwrites row S_max - 1 (ROADMAP C); the port raises."""
    _, tp = _tiers("bf16")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    _, cache = tdense.prefill(OPT_TINY, tp, {"tokens": toks}, pad_to=16)
    before = cache["k"].clone()
    with pytest.raises(ValueError, match="outside"):
        tdense.decode_step(OPT_TINY, tp, cache,
                           {"token": toks[:, 0], "kv_len": kv_len})
    assert torch.equal(cache["k"], before)


def test_reference_clamps_the_write_past_the_cache():
    """What the port's check replaces: at kv_len = S_max the reference
    writes the new rows over row S_max - 1."""
    params, jprefill, jdecode = _jax_opt_tiny()
    toks = jnp.zeros((1, 4), jnp.int32)
    _, cache = jprefill(params, {"tokens": toks}, pad_to=8)
    _, after = jdecode(params, cache, {"token": jnp.zeros((1,), jnp.int32),
                                       "kv_len": jnp.int32(8)})
    assert not bool(jnp.all(after["k"][:, :, 7] == cache["k"][:, :, 7]))
    assert bool(jnp.all(after["k"][:, :, :7] == cache["k"][:, :, :7]))
