"""The RG-LRU hybrid family in the port (``repro_torch/models/rglru.py``)
against the JAX package on recurrentgemma-9b's smoke config (5 layers: one
super-block (r1, r2, a) and 2 tail layers; window 16): ``forward``,
``prefill`` (every cache leaf) and greedy ``decode_step``s past the window
on the bf16 tree and the flash tier deployed at RBER 0 and 1e-4; the ring
layout against the reference's; the reference's own RG-LRU tests
(tests/test_models.py: scan = step, ring cache past the window) on the
port, and the scan against the JAX one; the arch smoke check; the compiled
decode step; ``run_deploy`` (plain and ``--store``) byte for byte against
the JAX ``run_deploy``, and JAX-saved checkpoints (the nested
``blocks/{r1,r2,a}`` and ``tail`` trees) restored by the port. Params come
from the JAX init, carried across with ``interop``; inputs are made with
numpy from a seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.launch import steps as tsteps
from repro_torch.models import rglru as trglru
from tests import torch_family_parity as fp

torch.set_num_threads(2)

ARCH = "recurrentgemma-9b"
# Logits: bf16 activations rounded one ulp apart now and then (XLA fuses
# the reference's bf16 elementwise chains inside its layer scans; the
# layers run op by op agree bit for bit), amplified by five random-init
# layers; the largest difference seen over this prompt, all tiers, is
# 2.8e-2 of the row's largest |logit| (4.2e-2 over other prompts). Bound:
# 2^-4 of it. Cache rows (16 values each): 5.2e-2 seen, bound 2^-3.
LOGIT_REL_TOL = 2.0 ** -4
CACHE_REL_TOL = 2.0 ** -3
# Margin-scanned prompt (numpy seed 5, one row of 20 tokens: past the
# window, so the prefill rolls the ring and the decode steps overwrite its
# oldest slots): every greedy step of the JAX run, on every tier, keeps its
# top-2 margin above 0.10; the largest absolute logit difference seen is
# 0.050 (ROADMAP §C).
PROMPT_SEED, PROMPT_SHAPE, N_DECODE, MIN_MARGIN = 5, (1, 20), 8, 0.1


def _prompt():
    cfg = fp.jax_arch(ARCH)[1]
    return np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, PROMPT_SHAPE).astype(np.int32)


@pytest.mark.parametrize("tier", fp.TIERS)
def test_prefill_and_greedy_decode_match_reference(tier):
    toks = _prompt()
    fp.greedy_parity(ARCH, tier, {"tokens": jnp.asarray(toks)},
                     {"tokens": torch.from_numpy(toks)}, PROMPT_SHAPE[1],
                     N_DECODE, LOGIT_REL_TOL, CACHE_REL_TOL, MIN_MARGIN)


def test_forward_matches_reference():
    jcfg, cfg, _, _, jp, _, _ = fp.jax_arch(ARCH)
    _, tp = fp.tiers(ARCH, "bf16")
    toks = _prompt()
    got = trglru.forward(cfg, tp, torch.from_numpy(toks))
    want = jrglru.forward(jcfg, jp, jnp.asarray(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert fp.rel_err(got, want) <= LOGIT_REL_TOL


@pytest.mark.parametrize("s", [5, 16, 37])
def test_ring_from_prefill_is_the_reference_layout(s):
    """Position p at slot p % window: short prompts padded, long ones
    rolled; the same bytes as the reference's."""
    jcfg, cfg = fp.jax_arch(ARCH)[:2]
    rng = np.random.default_rng(s)
    k, v = (np.asarray(jnp.asarray(rng.standard_normal(
        (1, 2, s, 1, 16), np.float32)).astype(jnp.bfloat16))
        for _ in range(2))
    got = trglru._ring_from_prefill(cfg, fp.t(k), fp.t(v), s)
    want = jrglru._ring_from_prefill(jcfg, jnp.asarray(k), jnp.asarray(v), s)
    for g, w in zip(got, want):
        assert g.shape[2] == cfg.local_window
        np.testing.assert_array_equal(fp.f32(g), fp.f32(w))


def test_decode_past_the_window_matches_reference():
    """Three windows of decode steps past a short prompt (the reference's
    long-context test, which feeds token 0): the ring keeps its shape, and
    every step's logits stay within the bound of the JAX step's."""
    jcfg, cfg, _, _, _, jprefill, jdecode = fp.jax_arch(ARCH)
    jp, tp = fp.tiers(ARCH, 1e-4)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (1, 8)).astype(np.int32)
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = trglru.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)})
    zero = np.zeros((1,), np.int32)
    for i in range(8, 8 + 3 * cfg.local_window):
        jl, jc = jdecode(jp, jc, {"token": jnp.asarray(zero),
                                  "kv_len": jnp.int32(i)})
        tl, tc = trglru.decode_step(cfg, tp, tc, {
            "token": torch.from_numpy(zero), "kv_len": i})
        assert fp.rel_err(tl, jl) <= LOGIT_REL_TOL, i
    assert bool(torch.isfinite(tl).all())
    assert tc["k"].shape[2] == cfg.local_window
    for name in jc:
        assert fp.rel_err(tc[name], jc[name]) <= CACHE_REL_TOL, name


def test_prompt_shorter_than_the_conv_matches_reference():
    """A 2-token prompt leaves a conv state of 2 rows, not W - 1 = 3 (the
    reference's ``u[:, -(W-1):]``): the decode steps read it with the
    taps aligned from the end, as the reference's zero-padded conv does."""
    jcfg, cfg, _, _, _, jprefill, jdecode = fp.jax_arch(ARCH)
    jp, tp = fp.tiers(ARCH, "bf16")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (1, 2)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = trglru.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tc["conv1"].shape) == jc["conv1"].shape == (1, 1, 2, 64)
    for i in range(2, 6):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jdecode(jp, jc, {"token": jnp.asarray(tok),
                                  "kv_len": jnp.int32(i)})
        tl, tc = trglru.decode_step(cfg, tp, tc, {
            "token": torch.from_numpy(tok), "kv_len": i})
        assert fp.rel_err(tl, jl) <= LOGIT_REL_TOL, i


def test_scan_equals_step_and_the_reference():
    """tests/test_models.py's check on the port: the full-sequence RG-LRU
    equals the step-by-step recurrence (the reference's tolerances); and
    the port's log-depth scan equals the JAX associative scan on the same
    inputs to f32 rounding (1e-5 of h's scale; h in u's dtype, f32 here)."""
    jcfg, cfg = fp.jax_arch(ARCH)[:2]
    p = jax.tree.map(np.asarray, jrglru._rec_mix_init(
        jcfg, jax.random.PRNGKey(0)))
    tp = {k: fp.t(v) for k, v in p.items()}
    b, s, r = 2, 9, cfg.lru_width
    u = np.random.default_rng(0).standard_normal((b, s, r),
                                                 np.float32) * 0.5
    h_seq, h_last = trglru.rg_lru_seq(tp, torch.from_numpy(u))
    h = torch.zeros((b, r))
    for i in range(s):
        out, h = trglru.rg_lru_step(tp, torch.from_numpy(u[:, i:i + 1]), h)
        torch.testing.assert_close(out[:, 0], h_seq[:, i], rtol=2e-2,
                                   atol=2e-2)
    torch.testing.assert_close(h, h_last, rtol=1e-3, atol=1e-3)
    jh_seq, jh_last = jrglru.rg_lru_seq(p, jnp.asarray(u))
    np.testing.assert_allclose(h_seq.numpy(), np.asarray(jh_seq), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh_last), rtol=0,
                               atol=1e-5)


def test_arch_smoke_prefill_decode_and_cache_shape():
    jcfg, cfg = fp.jax_arch(ARCH)[:2]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    cache = fp.structure_check(ARCH, {"tokens": toks})
    shape = trglru.cache_shape(cfg, 2, 64)
    want = jrglru.cache_shape(jcfg, 2, 64)
    assert set(shape) == set(want) == set(cache)
    for name, meta in shape.items():
        assert tuple(meta.shape) == want[name].shape \
            == tuple(cache[name].shape)
        assert meta.dtype == cache[name].dtype
    assert trglru.block_counts(cfg) == (1, 2)
    with pytest.raises(ValueError):
        trglru.decode_step(cfg, {}, cache, {"token": toks[:, 0],
                                            "kv_len": -1})


def test_compiled_decode_step_equals_eager_on_the_cpu():
    """make_decode_step(compiled=True) on CPU tensors runs the same body
    eagerly: bit-equal logits and every cache tensor across the ring's
    wrap, no capture."""
    cfg = fp.jax_arch(ARCH)[1]
    _, tp = fp.tiers(ARCH, 1e-4)
    toks = torch.from_numpy(_prompt()[:, :14])
    prefill = tsteps.make_prefill_step(cfg)
    (last, c1), (_, c2) = prefill(tp, {"tokens": toks}), \
        prefill(tp, {"tokens": toks})
    eager = tsteps.make_decode_step(cfg)
    comp = tsteps.make_decode_step(cfg, compiled=True)
    tok = last.argmax(-1)
    for i in range(14, 19):                  # slots 14, 15, 0, 1, 2
        lg1, c1 = eager(tp, c1, {"token": tok, "kv_len": i})
        lg2, c2 = comp(tp, c2, {"token": tok, "kv_len": i})
        assert torch.equal(lg1, lg2)
        tok = lg1.argmax(-1)
    assert comp.captures == 0
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    return fp.deploy_both(ARCH, tmp_path_factory.mktemp("deploy_rglru"))


@pytest.mark.parametrize("store", [False, True], ids=["plain", "store"])
def test_deploy_writes_the_reference_bytes(deployed, store):
    fp.assert_same_deploy(deployed, store)


def test_jax_checkpoints_restore_in_the_port(tmp_path):
    fp.assert_checkpoints_restore(ARCH, tmp_path)
