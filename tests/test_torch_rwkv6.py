"""The RWKV-6 family in the port (``repro_torch/models/rwkv6.py``) against
the JAX package on rwkv6-3b's smoke config: ``forward``, ``prefill`` (every
state leaf) and greedy ``decode_step``s on the bf16 tree and the flash tier
deployed at RBER 0 and 1e-4; the reference's own RWKV tests
(tests/test_models.py: decode = forward, chunked wkv = scan, extreme
decay) on the port; the wkv forms against the JAX ones; the arch smoke
check; the compiled decode step; ``run_deploy`` (plain and ``--store``)
byte for byte against the JAX ``run_deploy``, and JAX-saved checkpoints
restored by the port. Params come from the JAX init, carried across with
``interop``; inputs are made with numpy from a seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro_torch.launch import steps as tsteps
from repro_torch.models import rwkv6 as trwkv
from tests import torch_family_parity as fp

torch.set_num_threads(2)

ARCH = "rwkv6-3b"
# Logits of the two packages: bf16 activations whose f32 sums run in
# another order (XLA fuses the reference's bf16 elementwise chains) round
# one ulp apart now and then, and two random-init layers amplify those
# flips; the largest difference seen over this prompt, all tiers, is
# 8.6e-3 of the row's largest |logit|. Bound: 2^-5 of it. The state's
# rows (64 or 16 values each) 4.8e-2 of their largest: bound 2^-3.
LOGIT_REL_TOL = 2.0 ** -5
CACHE_REL_TOL = 2.0 ** -3
# Margin-scanned prompt (numpy seed 45, one row of 12 tokens): every greedy
# step of the JAX run, on every tier, keeps its top-2 margin above 0.14;
# the largest absolute logit difference seen is 0.0142 (ROADMAP §C).
PROMPT_SEED, PROMPT_SHAPE, N_DECODE, MIN_MARGIN = 45, (1, 12), 8, 0.05


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


@pytest.mark.parametrize("wkv_mode", ["chunked", "scan"])
def test_forward_matches_reference(wkv_mode):
    jcfg, cfg, _, _, jp, _, _ = fp.jax_arch(ARCH)
    _, tp = fp.tiers(ARCH, "bf16")
    toks = _prompt()
    got = trwkv.forward(cfg, tp, torch.from_numpy(toks), wkv_mode=wkv_mode)
    want = jrwkv.forward(jcfg, jp, jnp.asarray(toks), wkv_mode=wkv_mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert fp.rel_err(got, want) <= LOGIT_REL_TOL


def test_decode_matches_forward():
    """tests/test_models.py's RWKV check on the port: prefill 5 tokens,
    decode 5 teacher-forced; each step's logits are the scan forward's at
    that position (the reference's tolerances)."""
    _, cfg, _, _, _, _, _ = fp.jax_arch(ARCH)
    _, tp = fp.tiers(ARCH, "bf16")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32))
    logits = trwkv.forward(cfg, tp, toks, wkv_mode="scan")
    last, cache = trwkv.prefill(cfg, tp, {"tokens": toks[:, :5]})
    torch.testing.assert_close(last, logits[:, 4], rtol=2e-2, atol=2e-2)
    for i in range(5, 10):
        lg, cache = trwkv.decode_step(cfg, tp, cache,
                                      {"token": toks[:, i], "kv_len": i})
        torch.testing.assert_close(lg, logits[:, i], rtol=5e-2, atol=5e-2)


def _wkv_inputs(seed, b=2, s=50, h=3, k=8):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, s, h, k), np.float32)
                for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, k), np.float32) * 0.5
                   - 1.0)
    u = rng.standard_normal((h, k), np.float32)
    s0 = rng.standard_normal((b, h, k, k), np.float32)
    return r, kk, v, logw, u, s0


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_wkv_chunked_equals_scan_and_the_reference(chunk):
    """The blocked two-level wkv equals the per-token recurrence (the
    reference's test, its tolerance), and each form equals the JAX one on
    the same inputs: f32 sums in another order, within 1e-5."""
    ins = _wkv_inputs(chunk)
    tins = [torch.from_numpy(a) for a in ins]
    o1, st1 = trwkv.wkv_scan(*tins)
    o2, st2 = trwkv.wkv_chunked(*tins, chunk=chunk)
    torch.testing.assert_close(o2, o1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st2, st1, rtol=1e-4, atol=1e-4)
    jo1, jst1 = jrwkv.wkv_scan(*map(jnp.asarray, ins))
    jo2, jst2 = jrwkv.wkv_chunked(*map(jnp.asarray, ins), chunk=chunk)
    for got, want in ((o1, jo1), (st1, jst1), (o2, jo2), (st2, jst2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_wkv_chunked_extreme_decay_stable():
    """Near-total forgetting (log w = -30) must not overflow the chunked
    form (the reference's test)."""
    ones = torch.ones((1, 64, 2, 4))
    logw = torch.full((1, 64, 2, 4), -30.0)
    u, s0 = torch.zeros((2, 4)), torch.zeros((1, 2, 4, 4))
    o1, _ = trwkv.wkv_scan(ones, ones, ones, logw, u, s0)
    o2, _ = trwkv.wkv_chunked(ones, ones, ones, logw, u, s0, chunk=16)
    assert bool(torch.isfinite(o2).all())
    torch.testing.assert_close(o2, o1, rtol=1e-5, atol=1e-5)


def test_arch_smoke_prefill_decode_and_cache_shape():
    cfg = fp.jax_arch(ARCH)[1]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    cache = fp.structure_check(ARCH, {"tokens": toks})
    shape = trwkv.cache_shape(cfg, 2, 64)
    want = jrwkv.cache_shape(fp.jax_arch(ARCH)[0], 2, 64)
    for name, meta in shape.items():
        assert tuple(meta.shape) == want[name].shape \
            == tuple(cache[name].shape)
        assert meta.dtype == cache[name].dtype


def test_compiled_decode_step_equals_eager_on_the_cpu():
    """make_decode_step(compiled=True) on CPU tensors runs the same body
    eagerly: bit-equal logits and state, no capture."""
    cfg = fp.jax_arch(ARCH)[1]
    _, tp = fp.tiers(ARCH, 1e-4)
    toks = torch.from_numpy(_prompt())
    prefill = tsteps.make_prefill_step(cfg)
    (last, c1), (_, c2) = prefill(tp, {"tokens": toks}), \
        prefill(tp, {"tokens": toks})
    eager = tsteps.make_decode_step(cfg)
    comp = tsteps.make_decode_step(cfg, compiled=True)
    tok = last.argmax(-1)
    for i in range(3):
        lg1, c1 = eager(tp, c1, {"token": tok, "kv_len": 12 + i})
        lg2, c2 = comp(tp, c2, {"token": tok, "kv_len": 12 + i})
        assert torch.equal(lg1, lg2)
        tok = lg1.argmax(-1)
    assert comp.captures == 0
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    return fp.deploy_both(ARCH, tmp_path_factory.mktemp("deploy_rwkv6"))


@pytest.mark.parametrize("store", [False, True], ids=["plain", "store"])
def test_deploy_writes_the_reference_bytes(deployed, store):
    fp.assert_same_deploy(deployed, store)


def test_jax_checkpoints_restore_in_the_port(tmp_path):
    fp.assert_checkpoints_restore(ARCH, tmp_path)
