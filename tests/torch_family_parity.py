"""Shared parity machinery for the port's RWKV-6, RG-LRU and
encoder-decoder tests (``tests/test_torch_{rwkv6,rglru,encdec}.py``): the
JAX init of an arch's smoke config carried across with ``interop`` (bf16,
and the flash tier deployed at RBER 0 and 1e-4), greedy prefill + decode
in both packages under a stated logit tolerance and a margin-scanned
prompt, and the deploy / checkpoint byte checks against the JAX
``run_deploy`` and ``CheckpointManager``."""
from __future__ import annotations

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget
from repro.core import tiering as jtier
from repro.launch import deploy as jdeploy
from repro.models import family_module as jfamily
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.tiering import deploy
from repro_torch.launch import deploy as tdeploy
from repro_torch.models import family_module

TIERS = ["bf16", 0.0, 1e-4]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t(a) -> torch.Tensor:
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| of its last axis (a row of
    logits; one cache row)."""
    got, want = f32(got), f32(want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(row_max, 1e-30)).max())


@functools.lru_cache(maxsize=None)
def jax_arch(arch: str):
    """(JAX smoke config, port smoke config, JAX module, port module, JAX
    init params from PRNGKey(0), jitted JAX prefill, jitted JAX decode)."""
    jcfg = jget(arch, smoke=True)
    jm = jfamily(jcfg.family)
    params = jm.init(jcfg, jax.random.PRNGKey(0))
    prefill = jax.jit(functools.partial(jm.prefill, jcfg),
                      static_argnames=("pad_to",))
    decode = jax.jit(functools.partial(jm.decode_step, jcfg))
    cfg = get_config(arch, smoke=True)
    return jcfg, cfg, jm, family_module(cfg.family), params, prefill, decode


@functools.lru_cache(maxsize=None)
def tiers(arch: str, tier):
    """(JAX params, port params) of ``arch``-smoke: bf16, or deployed at
    RBER ``tier`` (seed 0) by the JAX deploy and carried across."""
    params = jax_arch(arch)[4]
    if tier == "bf16":
        return params, interop.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu")
    deployed, _ = jtier.deploy(params, rber=tier, seed=0)
    return deployed, interop.deployed_from_numpy(
        jax.tree.map(np.asarray, deployed), device="cpu")


def greedy_parity(arch: str, tier, jbatch: dict, tbatch: dict, start: int,
                  n_decode: int, logit_tol: float, cache_tol: float,
                  min_margin: float, pad_to: int | None = None) -> None:
    """Prefill ``jbatch`` / ``tbatch`` in both packages, then ``n_decode``
    greedy decode steps from kv_len ``start``: the port's greedy tokens
    equal the JAX run's at every step, each step's logits within
    ``logit_tol`` of the row's largest |logit| and every cache leaf, after
    the prefill and after the last step, within ``cache_tol`` of its row's
    largest |value|; every JAX step's top-2 margin exceeds ``min_margin``
    (the prompt is margin-scanned)."""
    jcfg, cfg, jm, tm, _, jprefill, jdecode = jax_arch(arch)
    jp, tp = tiers(arch, tier)
    j_last, j_cache = jprefill(jp, jbatch, pad_to=pad_to)
    t_last, t_cache = tm.prefill(cfg, tp, tbatch, pad_to=pad_to)
    assert set(t_cache) == set(j_cache)

    def caches(what):
        for name in j_cache:
            assert tuple(t_cache[name].shape) == j_cache[name].shape, name
            assert str(t_cache[name].dtype)[6:] == str(j_cache[name].dtype)
            err = rel_err(t_cache[name], j_cache[name])
            assert err <= cache_tol, (what, name, err)

    caches("prefill")
    for step in range(n_decode + 1):
        err = rel_err(t_last, j_last)
        assert err <= logit_tol, (step, err)
        top2 = np.sort(f32(j_last), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > min_margin, \
            f"step {step}: the prompt is not margin-safe"
        j_tok = np.asarray(jnp.argmax(j_last, -1), np.int32)
        t_tok = t_last.argmax(-1).int()
        np.testing.assert_array_equal(t_tok.numpy(), j_tok)
        if step == n_decode:
            break
        j_last, j_cache = jdecode(jp, j_cache, {
            "token": jnp.asarray(j_tok), "kv_len": jnp.int32(start + step)})
        t_last, t_cache2 = tm.decode_step(cfg, tp, t_cache, {
            "token": t_tok, "kv_len": start + step})
        assert t_cache2 is t_cache                    # written in place
    caches("after decode")


def files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def deploy_both(arch: str, root: Path) -> dict:
    """``arch``-smoke deployed by both packages from one JAX-written params
    checkpoint (rber 1e-3), with a die image and without; each run in a
    directory of its own with the same relative paths. Returns {(package,
    store): (stats, out dir)}."""
    JManager(root / "params").save(0, jax_arch(arch)[4])
    runs, cwd = {}, os.getcwd()
    for pkg, run in (("jax", jdeploy.run_deploy),
                     ("port", lambda *a, **k: tdeploy.run_deploy(
                         *a, device="cpu", **k))):
        for store in (False, True):
            d = root / pkg / ("store" if store else "plain")
            d.mkdir(parents=True)
            os.chdir(d)
            try:
                stats = run(arch, True, str(root / "params"), "out",
                            rber=1e-3,
                            store_path="out/nand.img" if store else None)
            finally:
                os.chdir(cwd)
            runs[pkg, store] = (stats, d / "out")
    return runs


def assert_same_deploy(runs: dict, store: bool) -> None:
    """The same stats and files, byte for byte (checkpoint; with a store
    the die image and its page table too)."""
    (jstats, jout), (tstats, tout) = runs["jax", store], runs["port", store]
    assert tstats == jstats
    jfiles, tfiles = files(jout), files(tout)
    names = {"LATEST", "step_00000000/manifest.json",
             "step_00000000/arrays.npz"}
    if store:
        names |= {"nand.img", "nand.img.meta.json"}
    assert set(tfiles) == set(jfiles) == names
    for name in sorted(names):
        assert tfiles[name] == jfiles[name], name
    if store:   # the reference programs attention flash copies for dense only
        assert "attn_flash" not in (tout / "nand.img.meta.json").read_text()


def assert_checkpoints_restore(arch: str, tmp: Path) -> None:
    """A JAX-saved checkpoint of the params tree and of the deployed tree
    (RBER 1e-3) restores onto the port's own trees (its ``init`` and
    ``deploy``): every leaf equal to the JAX one; written back by the port,
    the same bytes."""
    _, cfg, _, tm, params, _, _ = jax_arch(arch)
    jdep, _ = jtier.deploy(params, rber=1e-3, seed=0)
    raw = tm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    for name, jtree, template, want in (
            ("params", params, raw, interop.params_from_numpy(
                jax.tree.map(np.asarray, params), device="cpu")),
            ("deployed", jdep, deploy(raw, rber=0.0)[0],
             interop.deployed_from_numpy(jax.tree.map(np.asarray, jdep),
                                         device="cpu"))):
        JManager(tmp / name).save(0, jtree)
        got, _ = CheckpointManager(tmp / name).restore(template, device="cpu")
        flat_got, flat_want = _leaves(got), _leaves(want)
        assert list(flat_got) == list(flat_want), name
        for path, leaf in flat_got.items():
            assert leaf.dtype == flat_want[path].dtype, (name, path)
            assert torch.equal(leaf, flat_want[path]), (name, path)
        CheckpointManager(tmp / f"{name}_port", keep=1).save(0, got)
        assert files(tmp / f"{name}_port") == files(tmp / name), name


def _leaves(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v, p = tree[k], f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, p))
        elif hasattr(v, "parity"):
            out.update({f"{p}.q": v.q, f"{p}.parity": v.parity,
                        f"{p}.scale": v.scale})
        else:
            out[p] = v
    return out


def structure_check(arch: str, batch: dict) -> dict:
    """The reference's ``test_arch_smoke_prefill_decode`` on the port, at
    the smoke config with the port's own init: prefill (pad_to 64) gives
    finite (B, V) logits; one decode step at kv_len 32 gives finite
    (B, V) logits and a cache of the same keys, shapes and dtypes, the
    tensors written in place. Returns the cache."""
    cfg = get_config(arch, smoke=True)
    tm = family_module(cfg.family)
    params = tm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    last, cache = tm.prefill(cfg, params, batch, pad_to=64)
    b = last.shape[0]
    assert tuple(last.shape) == (b, cfg.vocab_size)
    assert bool(torch.isfinite(last).all())
    before = {k: (v.shape, v.dtype, v.data_ptr()) for k, v in cache.items()}
    lg, cache2 = tm.decode_step(cfg, params, cache,
                                {"token": last.argmax(-1).int(),
                                 "kv_len": 32})
    assert tuple(lg.shape) == (b, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
    assert {k: (v.shape, v.dtype, v.data_ptr())
            for k, v in cache2.items()} == before
    return cache
