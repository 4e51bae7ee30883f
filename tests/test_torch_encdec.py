"""The encoder-decoder family in the port (``repro_torch/models/encdec.py``)
against the JAX package on seamless-m4t-medium's smoke config (2 + 2
layers, the stub frames frontend): ``encode``, ``forward``, ``prefill``
(self- and cross-KV, padded) and greedy ``decode_step``s on the bf16 tree
and the flash tier deployed at RBER 0 and 1e-4; teacher-forced decode
against forward; the arch smoke check; the compiled decode step and the
cache bound; ``run_deploy`` (plain and ``--store``) byte for byte against
the JAX ``run_deploy``, and JAX-saved checkpoints (the ``enc`` / ``dec``
trees) restored by the port. Params come from the JAX init, carried
across with ``interop``; source frames and prompts are made with numpy
from a seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as tencdec
from tests import torch_family_parity as fp

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
# Logits: bf16 activations rounded one ulp apart now and then (XLA fuses
# the reference's bf16 elementwise chains), amplified by four random-init
# layers; the largest difference seen over this batch, all tiers, is
# 1.2e-2 of the row's largest |logit|. Bound: 2^-5 of it. Cache rows (16
# values each): 2.3e-2 seen, bound 2^-4.
LOGIT_REL_TOL = 2.0 ** -5
CACHE_REL_TOL = 2.0 ** -4
# Margin-scanned batch (numpy seed 26: 2 x 12 source frames, then 2 x 6
# target tokens): every greedy step of the JAX run, on every tier, keeps
# its top-2 margin above 0.084; the largest absolute logit difference
# seen is 0.0165 (ROADMAP §C).
SEED, B, SRC_LEN, TGT_LEN, PAD_TO, N_DECODE, MIN_MARGIN = \
    26, 2, 12, 6, 32, 8, 0.04


def _batch(seed=SEED, b=B, src_len=SRC_LEN, tgt_len=TGT_LEN):
    """(JAX batch, port batch): source frames (bf16) and target tokens."""
    cfg = fp.jax_arch(ARCH)[1]
    rng = np.random.default_rng(seed)
    src = np.asarray(jnp.asarray(rng.standard_normal(
        (b, src_len, cfg.d_model), np.float32)).astype(jnp.bfloat16))
    toks = rng.integers(0, cfg.vocab_size, (b, tgt_len)).astype(np.int32)
    return ({"src_embeds": jnp.asarray(src), "tgt_tokens": jnp.asarray(toks)},
            {"src_embeds": fp.t(src), "tgt_tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("tier", fp.TIERS)
def test_prefill_and_greedy_decode_match_reference(tier):
    jb, tb = _batch()
    fp.greedy_parity(ARCH, tier, jb, tb, TGT_LEN, N_DECODE, LOGIT_REL_TOL,
                     CACHE_REL_TOL, MIN_MARGIN, pad_to=PAD_TO)


def test_encode_and_forward_match_reference():
    jcfg, cfg, _, _, jp, _, _ = fp.jax_arch(ARCH)
    _, tp = fp.tiers(ARCH, "bf16")
    jb, tb = _batch()
    enc = tencdec.encode(cfg, tp, tb["src_embeds"])
    want_enc = jencdec.encode(jcfg, jp, jb["src_embeds"])
    assert enc.dtype == torch.bfloat16 and tuple(enc.shape) == want_enc.shape
    assert fp.rel_err(enc, want_enc) <= CACHE_REL_TOL
    got = tencdec.forward(cfg, tp, tb["src_embeds"], tb["tgt_tokens"])
    want = jencdec.forward(jcfg, jp, jb["src_embeds"], jb["tgt_tokens"])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert fp.rel_err(got, want) <= LOGIT_REL_TOL


def test_teacher_forced_decode_matches_forward():
    """Prefill 4 target tokens, decode 6 teacher-forced: each step's logits
    are forward's at that position (the reference's decode tolerances for
    the dense family: decode rounds p to bf16, forward keeps it f32)."""
    cfg = fp.jax_arch(ARCH)[1]
    _, tp = fp.tiers(ARCH, 0.0)
    _, tb = _batch(seed=3, b=2, tgt_len=10)
    src, toks = tb["src_embeds"], tb["tgt_tokens"]
    logits = tencdec.forward(cfg, tp, src, toks)
    last, cache = tencdec.prefill(cfg, tp, {"src_embeds": src,
                                            "tgt_tokens": toks[:, :4]},
                                  pad_to=16)
    torch.testing.assert_close(last, logits[:, 3], rtol=2e-2, atol=2e-2)
    for i in range(4, 10):
        lg, cache = tencdec.decode_step(cfg, tp, cache,
                                        {"token": toks[:, i], "kv_len": i})
        torch.testing.assert_close(lg, logits[:, i], rtol=5e-2, atol=5e-2)


def test_arch_smoke_prefill_decode_and_cache_shape():
    jcfg, cfg = fp.jax_arch(ARCH)[:2]
    _, tb = _batch(seed=2, src_len=32, tgt_len=32)
    cache = fp.structure_check(ARCH, tb)
    shape = tencdec.cache_shape(cfg, 2, 64, src_len=32)
    want = jencdec.cache_shape(jcfg, 2, 64, src_len=32)
    assert set(shape) == set(want) == set(cache)
    for name, meta in shape.items():
        assert tuple(meta.shape) == want[name].shape \
            == tuple(cache[name].shape)
        assert meta.dtype == cache[name].dtype
    assert tuple(tencdec.cache_shape(cfg, 2, 64)["ck"].shape) \
        == jencdec.cache_shape(jcfg, 2, 64)["ck"].shape


def test_compiled_decode_step_equals_eager_and_checks_the_cache():
    """make_decode_step(compiled=True) on CPU tensors runs the same body
    eagerly: bit-equal logits and caches, no capture; kv_len outside the
    self-KV raises before anything is written (the reference clamps)."""
    cfg = fp.jax_arch(ARCH)[1]
    _, tp = fp.tiers(ARCH, 1e-4)
    _, tb = _batch()
    prefill = tsteps.make_prefill_step(cfg, pad_to=12)
    (last, c1), (_, c2) = prefill(tp, tb), prefill(tp, tb)
    eager = tsteps.make_decode_step(cfg)
    comp = tsteps.make_decode_step(cfg, compiled=True)
    tok = last.argmax(-1)
    for i in range(TGT_LEN, 12):
        lg1, c1 = eager(tp, c1, {"token": tok, "kv_len": i})
        lg2, c2 = comp(tp, c2, {"token": tok, "kv_len": i})
        assert torch.equal(lg1, lg2)
        tok = lg1.argmax(-1)
    assert comp.captures == 0
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
    before = {k: v.clone() for k, v in c1.items()}
    with pytest.raises(ValueError, match="outside"):
        eager(tp, c1, {"token": tok, "kv_len": 12})
    assert all(torch.equal(c1[k], before[k]) for k in c1)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    return fp.deploy_both(ARCH, tmp_path_factory.mktemp("deploy_encdec"))


@pytest.mark.parametrize("store", [False, True], ids=["plain", "store"])
def test_deploy_writes_the_reference_bytes(deployed, store):
    fp.assert_same_deploy(deployed, store)


def test_jax_checkpoints_restore_in_the_port(tmp_path):
    fp.assert_checkpoints_restore(ARCH, tmp_path)
