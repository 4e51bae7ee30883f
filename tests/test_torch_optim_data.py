"""The port's optimizer, schedules, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.data.pipeline``) against the JAX
package's: tests/test_optim_data.py's scenarios on the port, then the two
packages side by side on the same inputs.

Bounds: AdamW's moments within one f32 ulp and its params within one bf16
ulp of the reference's without clipping (bit for bit here); with clipping
the moments also carry the clip scale's rounding (the global norm's, below
2^-19 of it): within one ulp plus 2^-18 of the leaf's largest moment (m's
sum cancels), plus one bf16 ulp for bf16 moments (whose rounding that
can flip). ``global_norm``
within 2^-16 of the reference's (the two sum in different orders: 10 ulps
apart at 6,000 bf16 squares). ``warmup_cosine`` within one f32 ulp plus
2^-24 of the peak lr (XLA's f32 ``cos`` and torch's round an ulp apart at
some steps, and ``1 + cos`` near the end of the decay cancels).
Compressed all-reduce payloads byte-equal; batches byte-equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro_torch.data.pipeline import (DataConfig, FileTokens, Prefetcher,
                                       SyntheticLM, make_source)
from repro_torch.interop import tensor_from_numpy
from repro_torch.optim import AdamW, apply_updates, global_norm
from repro_torch.optim import constant, warmup_cosine
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.grad_compress import (_quantize, init_error_feedback,
                                             simulate_compressed_allreduce)

EPS32 = float(np.finfo(np.float32).eps)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- tests/test_optim_data.py's scenarios on the port -------------------------

def test_adamw_quadratic_convergence():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(120):
        grads = tree_map(lambda p: 2 * p, params)        # d/dp p^2
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_moment_dtype(dtype):
    opt = AdamW(lr=0.05, moment_dtype=dtype)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == getattr(torch, dtype)
    grads = {"w": torch.ones((4, 4))}
    updates, state = opt.update(grads, state, params)
    assert updates["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(state.v["w"].float()).all())


def test_grad_clipping():
    opt = AdamW(lr=1.0, clip_norm=1.0)
    params = {"w": torch.zeros((3,))}
    state = opt.init(params)
    huge = {"w": torch.tensor([1e6, 0.0, 0.0])}
    updates, state = opt.update(huge, state, params)
    assert float(global_norm(state.m)) <= 0.11   # clipped to norm 1 * (1-b1)


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 0.11
    assert float(lr(100)) <= 0.11
    assert float(lr(5)) < float(lr(10))


def test_compressed_allreduce_error_feedback():
    """EF makes the accumulated compressed-mean track the true mean."""
    rng = np.random.default_rng(0)
    n_workers, steps = 4, 30
    true_acc = np.zeros(64)
    comp_acc = np.zeros(64)
    errs = [init_error_feedback({"g": torch.zeros(64)})
            for _ in range(n_workers)]
    for _ in range(steps):
        grads = [{"g": torch.from_numpy(rng.normal(size=64) * (1 + w))}
                 for w in range(n_workers)]
        true_mean = np.mean([g["g"].numpy() for g in grads], axis=0)
        mean, errs = simulate_compressed_allreduce(grads, errs)
        true_acc += true_mean
        comp_acc += mean["g"].numpy()
    rel = np.linalg.norm(comp_acc - true_acc) / np.linalg.norm(true_acc)
    assert rel < 0.02, f"error feedback should bound drift, rel={rel}"


def test_synthetic_data_deterministic_and_learnable():
    cfg = DataConfig(vocab_size=97, seq_len=16, global_batch=4, seed=5)
    src = SyntheticLM(cfg)
    b1, b2 = src.batch(7), src.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = src.batch(8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["labels"].shape == (4, 16)
    toks, labs = b1["tokens"], b1["labels"]
    assert np.all((labs - 3 * toks) % 97 < 7)   # next = (3x + U[0,7)) % V


def test_host_sharding_partitions_batch():
    parts = [SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=8,
                                    n_hosts=2, host_id=h, seed=1)).batch(3)
             for h in range(2)]
    assert parts[0]["tokens"].shape == (4, 8)
    assert parts[1]["tokens"].shape == (4, 8)


def test_prefetcher_resume():
    src = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=2,
                                 seed=2))
    pf = Prefetcher(src, start_step=5, depth=2)
    step, batch = pf.next()
    assert step == 5
    np.testing.assert_array_equal(batch["tokens"], src.batch(5)["tokens"])
    step2, _ = pf.next()
    assert step2 == 6
    pf.close()
    assert not pf._thread.is_alive()


# --- side by side with the reference --------------------------------------------

def _tree(rng) -> dict:
    """Stacked (L, K, N) and (L, d) leaves, a (K, N) matrix and a vector:
    the shapes weight decay tells apart (ndim >= 2 decays)."""
    return {"layers": {"w": rng.normal(size=(3, 40, 50)),
                       "ln": rng.normal(size=(3, 50))},
            "head": rng.normal(size=(64, 33)),
            "norm": rng.normal(size=(50,))}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
def test_adamw_update_matches_reference(moment_dtype, clip):
    """Four AdamW steps from the same bf16 params on the same f32 grads
    (grads of norm about 90, so clipping acts), under warmup_cosine: each
    step's moments within one f32 ulp of the reference's (with clipping
    the bound above), its params within one bf16 ulp; ``apply_`` (in place) equals ``update`` +
    ``apply_updates`` bit for bit."""
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree(rng))
    tp = tree_map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
                  jax.tree.map(np.asarray, jp))
    tq = tree_map(torch.clone, tp)
    jo = jadamw.AdamW(lr=jsched.warmup_cosine(1e-2, 3, 10),
                      moment_dtype=moment_dtype, clip_norm=clip)
    to = AdamW(lr=warmup_cosine(1e-2, 3, 10), moment_dtype=moment_dtype,
               clip_norm=clip)
    js, ts = jo.init(jp), to.init(tp)
    tq_state = to.init(tq)
    assert tree_leaves(ts.m)[0].dtype == getattr(torch, moment_dtype)
    for _ in range(4):
        g = _tree(rng)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), g)
        tg = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), g)
        ju, js = jo.update(jg, js, jp)
        jp = jadamw.apply_updates(jp, ju)
        tu, ts = to.update(tg, ts, tp)
        tp = apply_updates(tp, tu)
        tq_state = to.apply_(tg, tq_state, tq)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        for want, got in ((js.m, ts.m), (js.v, ts.v)):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                a, b = _np(a), _np(b)
                tol = np.spacing(np.abs(a).astype(np.float32))
                if clip is not None:
                    # the scale's rounding, through m's cancelling sum,
                    # and a stored bf16 moment's rounding it may flip
                    tol = tol + np.abs(a).max() * 2.0 ** -18
                    if moment_dtype == "bfloat16":
                        tol = tol + np.abs(a) * 2.0 ** -7
                assert np.all(np.abs(a - b) <= tol)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            a, b = _np(a), _np(b)
            assert np.all(np.abs(a - b) <= np.abs(a) * 2.0 ** -7 + 1e-30)
        for mine, other in ((tp, tq), (ts.m, tq_state.m), (ts.v, tq_state.v)):
            for x, y in zip(tree_leaves(mine), tree_leaves(other)):
                assert torch.equal(x, y)


def test_adamw_update_leaves_its_inputs_alone():
    rng = np.random.default_rng(1)
    params = tree_map(torch.from_numpy, _tree(rng))
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    grads = tree_map(torch.from_numpy, _tree(rng))
    trees = (params, state.m, state.v, grads)
    keep = [t.clone() for tree in trees for t in tree_leaves(tree)]
    opt.update(grads, state, params)
    for a, b in zip(keep, [t for tree in trees for t in tree_leaves(tree)]):
        assert torch.equal(a, b)


def test_warmup_cosine_and_constant_match_reference():
    """Every step of both schedules (ints and 0-d int32 tensors) within
    one f32 ulp plus 2^-24 of the peak lr of the reference's."""
    for args in ((3e-3, 7, 100), (1.0, 10, 100), (1e-2, 1, 10, 0.0)):
        jl, tl = jsched.warmup_cosine(*args), warmup_cosine(*args)
        for s in range(0, 130):
            want = np.float32(jl(s))
            for step in (s, torch.tensor(s, dtype=torch.int32)):
                got = tl(step)
                assert got.dtype == torch.float32 and got.ndim == 0
                assert abs(float(got) - float(want)) <= \
                    np.spacing(want) + args[0] * 2.0 ** -24
    assert float(constant(0.25)(torch.tensor(3))) == \
        float(jsched.constant(0.25)(3))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    for dtype in (np.float32, jnp.bfloat16):
        tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), _tree(rng))
        want = float(jadamw.global_norm(tree))
        got = global_norm(tree_map(
            lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
            jax.tree.map(np.asarray, tree)))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= want * 2.0 ** -16


def test_compressed_allreduce_matches_reference():
    """Three rounds over 4 workers with error feedback: each worker's
    int8 payload and scale byte-equal to the reference's, the means and
    the carried errors within one f32 ulp of the mean's scale."""
    rng = np.random.default_rng(3)
    n = 4
    jerrs = [jgc.init_error_feedback({"a": jnp.zeros((8, 16)),
                                      "b": jnp.zeros(64)}) for _ in range(n)]
    terrs = [init_error_feedback({"a": torch.zeros((8, 16)),
                                  "b": torch.zeros(64)}) for _ in range(n)]
    for _ in range(3):
        g = [{"a": rng.normal(size=(8, 16)).astype(np.float32) * (w + 1),
              "b": rng.normal(size=64).astype(np.float32)} for w in range(n)]
        for w in range(n):
            for k in ("a", "b"):
                jq, js, _ = jgc._quantize(jnp.asarray(g[w][k]), jerrs[w][k])
                tq, ts, _ = _quantize(torch.from_numpy(g[w][k]),
                                      terrs[w][k])
                assert np.asarray(jq).tobytes() == tq.numpy().tobytes()
                assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        jmean, jerrs = jgc.simulate_compressed_allreduce(
            [jax.tree.map(jnp.asarray, x) for x in g], jerrs)
        tmean, terrs = simulate_compressed_allreduce(
            [tree_map(torch.from_numpy, x) for x in g], terrs)
        for k in ("a", "b"):
            want, got = np.asarray(jmean[k]), tmean[k].numpy()
            assert np.abs(want - got).max() <= np.abs(want).max() * EPS32
            for je, te in zip(jerrs, terrs):
                assert np.abs(np.asarray(je[k]) - te[k].numpy()).max() \
                    <= np.abs(g[0][k]).max() * (n + 1) * EPS32


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_the_reference(n_hosts, host_id, seed):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=4, n_hosts=n_hosts,
              host_id=host_id, seed=seed)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    got = SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 17):
        a, b = want.batch(step), got.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_file_tokens_equal_the_reference(tmp_path):
    """A binary int32 token file, several epochs (the per-epoch shuffle),
    two hosts: byte-equal batches; make_source picks FileTokens."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 5000, 16 * 9 + 1).astype(
        np.int32).tofile(path)
    for host_id in (0, 1):
        kw = dict(vocab_size=5000, seq_len=16, global_batch=4, n_hosts=2,
                  host_id=host_id, seed=3, path=str(path))
        want = jpipe.make_source(jpipe.DataConfig(**kw))
        got = make_source(DataConfig(**kw))
        assert isinstance(got, FileTokens)
        for step in range(5):
            a, b = want.batch(step), got.batch(step)
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()
    with pytest.raises(ValueError, match="too small"):
        FileTokens(DataConfig(vocab_size=5000, seq_len=16, global_batch=64,
                              path=str(path)))
