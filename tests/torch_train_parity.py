"""Shared machinery for the port's training tests
(``tests/test_torch_train_*.py``): an arch's smoke config with the JAX
init's params carried across by ``interop``, a family-shaped batch made
from a seed with numpy, and per-leaf comparisons.

The reference runs OP BY OP (``jax.disable_jit()``): its ``make_train_step``
is called unjitted in tests/test_integration.py, and under jit XLA fuses
the bf16 elementwise chains the port rounds op by op (scan bodies are
compiled even without an outer jit), which random-init smoke models
amplify into gradients 3-15 % apart. Op by op most rows' losses agree
within 5e-7; but torch's CPU bf16 GEMM and XLA's round an occasional sum
one ulp apart (granite-8b smoke: one element of a layer-0 ``wv`` product),
which moves that row's loss by up to 7e-4 and small leaves' gradients
by a few percent of their largest element. So the bounds: losses within
1e-3, each gradient leaf (and each first moment after a step) within
``grad_tol`` of its largest element, per family from its readings (the
worst leaf over the gradient and the n_micro 1 / 2 step checks, on the
CPU): granite-8b 8.1e-3 (the step's embed), llava-next-34b 6.2e-3,
qwen3-moe 1.0e-2, seamless 1.6e-2, rwkv6 3.0e-2 (``tmix.mu_x``),
recurrentgemma 4.1e-2 (the RG-LRU's gate biases); each bound the power
of two at 1.5-3x its reading.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import family_module as jfamily
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import common as cm
from repro_torch.models import family_module
from repro_torch.optim.adamw import tree_leaves

ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "rwkv6-3b", "recurrentgemma-9b",
         "seamless-m4t-medium"]
# of each gradient leaf's largest |element| (module docstring)
GRAD_TOL = {"granite-8b": 2.0 ** -6, "llava-next-34b": 2.0 ** -6,
            "qwen3-moe-30b-a3b": 2.0 ** -5,
            "seamless-m4t-medium": 2.0 ** -5, "rwkv6-3b": 2.0 ** -4,
            "recurrentgemma-9b": 2.0 ** -4}


def grad_tol(cfg) -> float:
    return GRAD_TOL[cfg.name.removesuffix("-smoke")]



def loss_tol(cfg) -> float:
    """Absolute, on losses near 6.3 (the RG-LRU's f32 scan also sums in
    another order than the reference's associative scan)."""
    del cfg
    return 1e-3


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    jcfg = jget(arch, smoke=True)
    return jfamily(jcfg.family).init(jcfg, jax.random.PRNGKey(0))


def setup(arch: str):
    """(JAX config, port config, JAX params, port params: the same
    numbers, bf16, on the CPU)."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax_params(arch)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jcfg, cfg, jp, tp


def batch(cfg, b: int, s: int, seed: int = 1, n_src: int = 10,
          n_patch: int = 4) -> dict:
    """A numpy batch of the family's shape: tokens / labels (B, S) int32;
    the encoder-decoder's ``src_embeds`` (B, n_src, D) f32 frames; the
    patch frontend's ``patch_embeds`` (B, n_patch, D) f32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out = {"src_embeds": rng.standard_normal(
                   (b, n_src, cfg.d_model), dtype=np.float32),
               "tgt_tokens": out["tokens"], "labels": out["labels"]}
    elif cfg.frontend == "patch":
        out["patch_embeds"] = rng.standard_normal(
            (b, n_patch, cfg.d_model), dtype=np.float32)
    return out


def both(nb: dict):
    """The numpy batch for each package."""
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def leaf_pairs(jtree, ttree):
    """(JAX path, JAX leaf, port leaf) in pytree order; the trees must
    have the same leaves."""
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(jl, tl)]


def worst_leaf_rel(jtree, ttree) -> tuple[float, str]:
    """The largest max |diff| / max |want| over the leaves, and its path;
    checks shapes and dtypes on the way."""
    worst, where = 0.0, ""
    for path, a, b in leaf_pairs(jtree, ttree):
        assert tuple(a.shape) == tuple(b.shape), path
        assert (str(a.dtype).replace("torch.", "")
                == str(b.dtype).replace("torch.", "")), (path, a.dtype,
                                                         b.dtype)
        a, b = f32(a), f32(b)
        assert np.isfinite(b).all(), path
        rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
        if rel > worst:
            worst, where = rel, path
    return worst, where


def value_and_grad_both(jcfg, cfg, jp, tp, nb):
    """(JAX loss, JAX grads: ``jax.value_and_grad`` op by op; port loss,
    port grads: ``launch.steps.value_and_grad``) on numpy batch ``nb``."""
    jb, tb = both(nb)
    jm = jfamily(jcfg.family)
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(
            lambda p: jm.train_loss(jcfg, p, jb))(jp)
    tl, tg = steps.value_and_grad(cfg, tp, tb)
    return float(jl), jg, tl, tg


def check_loss_and_grads(arch: str) -> None:
    """``arch``'s train_loss and every gradient leaf against the
    reference's (bounds above); the loss alone is the same number, and
    the params took no grad."""
    jcfg, cfg, jp, tp = setup(arch)
    nb = batch(cfg, 2, 24)
    jl, jg, tl, tg = value_and_grad_both(jcfg, cfg, jp, tp, nb)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert abs(float(tl) - jl) <= loss_tol(cfg), (float(tl), jl)
    worst, where = worst_leaf_rel(jg, tg)
    assert worst <= grad_tol(cfg), (where, worst)
    alone = family_module(cfg.family).train_loss(cfg, tp, both(nb)[1])
    assert float(alone) == float(tl)
    assert not any(p.requires_grad for p in tree_leaves(tp))


def check_short_window(arch: str, window: int, seq: int) -> None:
    """The local window shorter than the sequence, at a kv_block of 16:
    the chunked attention's -inf masks reach rows whose KV block the
    window masks whole. Every gradient finite, and within ``grad_tol`` of the
    port's own at the default kv_block (one block: no row masked whole;
    the reference's comparison at the smoke window is
    ``check_loss_and_grads``)."""
    _, cfg, _, tp = setup(arch)
    cfg = dataclasses.replace(cfg, local_window=window)
    tb = both(batch(cfg, 2, seq, seed=3))[1]
    wl, wg = steps.value_and_grad(cfg, tp, tb)
    chunked = cm.chunked_attention

    def small_blocks(*a, **kw):
        return chunked(*a, **{**kw, "kv_block": 16})
    cm.chunked_attention = small_blocks
    try:
        tl, tg = steps.value_and_grad(cfg, tp, tb)
    finally:
        cm.chunked_attention = chunked
    for g in tree_leaves(tg):
        assert bool(torch.isfinite(g).all())
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(wl)) <= loss_tol(cfg)
    worst, where = worst_leaf_rel(wg, tg)
    assert worst <= grad_tol(cfg), (where, worst)


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def check_train_step(arch: str, n_micro: int) -> None:
    """One ``make_train_step`` step of ``arch`` (AdamW under
    warmup_cosine(1e-2, 2, 10), 4 rows of 16 tokens, ``n_micro``
    microbatches) against the reference's step run op by op: the loss
    within ``loss_tol``, each first moment m (0.1 x the clipped gradient
    g) within ``grad_tol`` of its leaf's largest, and each param whose m has
    one sign in both packages within a bf16 ulp of it and one of the
    update (2^-7 (|p| + lr): the update is rounded to bf16 before it is
    added) plus lr eps (1/|g_jax| + 1/|g_port|): at step 1 an update is
    -lr g / (|g| + eps) (+ decay), lr x the gradient's sign less
    lr eps / |g|, so the two agree to an ulp where g is far above eps and
    part by up to that term near it; a sign the packages' roundings split
    moves the param by lr the other way, and every param is within
    2 lr + 2^-7 of it. The port's step updates in place and returns the
    params it was given, none requiring grad."""
    from repro.launch.steps import make_train_step as jstep
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.schedule import warmup_cosine as jwc
    from repro_torch.optim import AdamW, warmup_cosine

    jcfg, cfg, jp, tp = setup(arch)
    jb, tb = both(batch(cfg, 4, 16, seed=2))
    jo, to = JAdamW(lr=jwc(1e-2, 2, 10)), AdamW(lr=warmup_cosine(1e-2, 2, 10))
    with jax.disable_jit():
        jp2, js, jm = jstep(jcfg, jo, n_micro=n_micro)(jp, jo.init(jp), jb)
    given = tree_leaves(tp)
    tp2, ts, tm = steps.make_train_step(cfg, to, n_micro=n_micro)(
        tp, to.init(tp), tb)
    assert all(a is b for a, b in zip(tree_leaves(tp2), given))
    assert not any(p.requires_grad or p.grad is not None for p in given)
    assert int(ts.step) == 1 and ts.step.dtype == torch.int32
    assert tm["loss"].dtype == torch.float32 and tm["loss"].ndim == 0
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_tol(cfg)
    worst, where = worst_leaf_rel(js.m, ts.m)
    assert worst <= grad_tol(cfg), (where, worst)
    lr = float(to._lr(ts.step))
    for (path, a, b), (_, ma, mb) in zip(leaf_pairs(jp2, tp2),
                                         leaf_pairs(js.m, ts.m)):
        a, b, ma, mb = f32(a), f32(b), f32(ma), f32(mb)
        d = np.abs(a - b)
        big = (np.maximum(np.abs(a), np.abs(b)) + lr) * 2.0 ** -7
        assert d.max() <= 2 * lr + big.max(), path
        same = np.sign(ma) == np.sign(mb)
        with np.errstate(divide="ignore"):      # m = 0: its own sign
            tol = big + lr * 1e-9 * (1 / np.abs(ma) + 1 / np.abs(mb))
        assert np.all(d[same] <= tol[same]), path
