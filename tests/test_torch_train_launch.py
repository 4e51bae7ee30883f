"""The training driver (``repro_torch.launch.train``), its checkpoints
and the train -> checkpoint -> deploy -> serve lifecycle, on the CPU:
tests/test_integration.py's and tests/test_checkpoint_runtime.py's
training scenarios on the port, (params, AdamWState) checkpoints
byte-identical across the two packages, ``deploy --ckpt`` of a JAX
training checkpoint writing the JAX deploy's bytes, ``--production``'s
size error in a world of one, and ``python -m repro_torch.launch.train``.

``train()`` builds ``FaultPolicy()`` inside, whose straggler detector
raises ``StepFault`` after 3 consecutive steps slower than 3x the
trailing median: on a machine loaded by other test workers that fires on
a healthy run (ROADMAP §C: the reference's own
test_training_reduces_loss flakes on it), so the train scenarios set it
aside with a tolerance past their step count; the detector is tested on
its own below.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp_
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.data import pipeline as jpipe
from repro.launch import deploy as jdeploy
from repro.launch import train as jtrain
from repro.models import family_module as jfamily
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import OPT_TINY
from repro_torch.launch import deploy as tdeploy
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import dense
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault import (FaultPolicy, FaultTolerantExecutor,
                                       StepFault)
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_straggler(monkeypatch):
    """The straggler detector set aside (module docstring)."""
    monkeypatch.setattr(ttrain, "FaultPolicy",
                        lambda: FaultPolicy(straggler_tolerance=10**9))


def test_training_reduces_loss(no_straggler):
    out = ttrain.train("granite-8b", smoke=True, steps=80, batch=8, seq=32,
                       lr=1e-2, seed=0, device="cpu")
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.1, f"no learning: {first} -> {last}"
    assert all(not p.requires_grad for p in tree_leaves(out["params"]))


def test_train_restart_is_exact(tmp_path, no_straggler):
    """Kill at step 10, resume, and land on the checkpoint's step."""
    kw = dict(smoke=True, batch=2, seq=16, ckpt_dir=str(tmp_path),
              ckpt_every=5, lr=1e-3, seed=3, device="cpu")
    ttrain.train("granite-8b", steps=14, **kw)
    r2 = ttrain.train("granite-8b", steps=14, **kw)
    assert r2["start_step"] == 14       # fully trained, nothing to redo
    assert np.isnan(r2["losses"]).all()
    r3 = ttrain.train("granite-8b", steps=16, **kw)
    assert r3["start_step"] == 14
    assert len(r3["losses"]) == 2


@pytest.fixture
def held_writes(monkeypatch):
    """``save_async``'s background write held until the next ``wait``
    (the next save, or the end of training), so whatever the caller does
    to its tensors in between lands before the write; each save_async's
    state recorded as clones at the call."""
    write, wait = CheckpointManager._write, CheckpointManager.wait
    go, armed, saved = {}, set(), {}

    def held_write(self, step, *a):
        if step in go:                  # not a blocking save's
            go[step].wait()
        write(self, step, *a)

    def releasing_wait(self):
        for step in armed:
            go[step].set()
        wait(self)

    def recording_save_async(self, step, state, extras=None):
        saved[step] = [t.clone() for t in _state_leaves(state)]
        go[step] = threading.Event()
        save_async(self, step, state, extras)    # its wait() releases the
        armed.add(step)                          # earlier writes only

    save_async = CheckpointManager.save_async
    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    monkeypatch.setattr(CheckpointManager, "wait", releasing_wait)
    monkeypatch.setattr(CheckpointManager, "save_async", recording_save_async)
    return saved


def _state_leaves(state):
    params, opt_state = state
    return (tree_leaves(params) + [opt_state.step] + tree_leaves(opt_state.m)
            + tree_leaves(opt_state.v))


def test_save_async_snapshots_cpu_tensors(tmp_path, held_writes):
    """A CPU tree written in place right after ``save_async`` is checkpointed
    as it was at the call: the snapshot copies a CPU tensor too."""
    _, _, _, tp = tp_.setup("granite-8b")
    opt = AdamW()
    state = (tp, opt.init(tp))
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(0, state, {"step": 0})
    with torch.no_grad():
        for t in _state_leaves(state):
            t.add_(1)
    mgr.wait()
    got, _ = mgr.restore(state, device="cpu")
    for a, b in zip(held_writes[0], _state_leaves(got)):
        assert torch.equal(a, b)


def test_train_async_checkpoints_hold_their_step(tmp_path, held_writes,
                                                 no_straggler):
    """train() on the CPU (its step updates params and moments in place):
    each intermediate async checkpoint, written only after the following
    steps ran, holds the (params, AdamW) of its own step bit for bit."""
    ttrain.train("granite-8b", smoke=True, steps=5, batch=2, seq=16,
                 ckpt_dir=str(tmp_path), ckpt_every=2, lr=1e-2, seed=2,
                 device="cpu")
    assert sorted(held_writes) == [1, 3]
    mgr = CheckpointManager(tmp_path)
    assert sorted(mgr.all_steps()) == [1, 3, 4]
    assert mgr.latest_step() == 4       # step 3's write landed before it
    _, cfg, _, tp = tp_.setup("granite-8b")
    template = (tp, AdamW().init(tp))
    for step, want in held_writes.items():
        got, extras = mgr.restore(template, step=step, device="cpu")
        assert extras == {"step": step}
        assert int(got[1].step) == step + 1
        for a, b in zip(want, _state_leaves(got)):
            assert torch.equal(a, b)
    final, _ = mgr.restore(template, step=4, device="cpu")
    assert not torch.equal(_state_leaves(final)[0], held_writes[3][0])


def test_train_with_fault_injection(tmp_path, no_straggler):
    hits = {"n": 0}

    def hook(step, retries):
        if step == 4 and retries == 0:
            hits["n"] += 1
            raise StepFault("injected device loss")

    r = ttrain.train("granite-8b", smoke=True, steps=8, batch=2, seq=16,
                     ckpt_dir=str(tmp_path), ckpt_every=3, lr=1e-3, seed=1,
                     fault_hook=hook, device="cpu")
    assert hits["n"] == 1
    assert len(r["losses"]) == 8
    assert np.isfinite(r["losses"]).all()


def test_straggler_detector_raises_on_persistent_stragglers():
    """3 consecutive steps slower than 3x the trailing median after 4
    timed steps raise StepFault (the detector set aside above)."""
    delays = iter([0.001] * 4 + [0.06] * 3)
    ex = FaultTolerantExecutor(lambda: time.sleep(next(delays)),
                               FaultPolicy(straggler_factor=3.0,
                                           straggler_tolerance=3))
    for step in range(6):
        ex.run_step(step)
    with pytest.raises(StepFault, match="persistent straggler at step 6"):
        ex.run_step(6)


def test_train_deploy_serve_pipeline(tmp_path):
    """The full lifecycle: train -> checkpoint -> deploy tiered -> serve."""
    jp = jfamily("dense").init(J_OPT_TINY, jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    step = make_train_step(OPT_TINY, opt)
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        toks = torch.randint(0, OPT_TINY.vocab_size, (4, 32), generator=gen)
        params, opt_state, m = step(params, opt_state,
                                    {"tokens": toks, "labels": toks})
    assert np.isfinite(float(m["loss"]))
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(5, params, {"step": 5})
    restored, _ = mgr.restore(params, device="cpu")
    eng = Engine(OPT_TINY, restored, max_slots=2, max_seq=64, rber=1e-4,
                 device="cpu")
    rid = eng.submit([1, 2, 3], max_new=4)
    out = eng.run()
    assert len(out[rid]) == 4


def test_train_feeds_the_reference_batches(monkeypatch, no_straggler):
    """train() on the JAX init's params: its first loss is the JAX
    train_loss (op by op) of the reference pipeline's batch 0, within
    tests/torch_train_parity.py's bound."""
    jcfg, cfg, jp, tp = tp_.setup("granite-8b")
    monkeypatch.setattr(dense, "init", lambda c, gen, device="cuda":
                        tp_.clone_tree(tp))
    out = ttrain.train("granite-8b", smoke=True, steps=2, batch=4, seq=16,
                       seed=7, device="cpu")
    host = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4,
        seed=7)).batch(0)
    with jax.disable_jit():
        want = float(jfamily("dense").train_loss(
            jcfg, jp, jax.tree.map(jnp.asarray, host)))
    assert abs(out["losses"][0] - want) <= tp_.loss_tol(cfg)


@pytest.fixture(scope="module")
def jax_training_ckpt(tmp_path_factory):
    """A JAX (params, AdamWState) checkpoint of granite-8b smoke after one
    AdamW update (moments nonzero, step 1), as the reference's train()
    writes it."""
    root = tmp_path_factory.mktemp("jax_train")
    jcfg, _, jp, _ = tp_.setup("granite-8b")
    opt = JAdamW(lr=1e-2)
    state = opt.init(jp)
    grads = jax.tree.map(lambda p: jnp.ones(p.shape, jnp.float32) * 1e-3, jp)
    updates, state = opt.update(grads, state, jp)
    params = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, updates)
    JManager(root / "ckpt").save(0, (params, state), {"step": 0})
    return root, params, state


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_training_checkpoints_are_byte_identical_across_packages(
        jax_training_ckpt, tmp_path):
    """The JAX (params, AdamWState) checkpoint restores in the port
    (leaves byte-identical, an AdamWState with a 0-d int32 step); the
    port saves it back byte for byte, and the JAX package restores the
    port's."""
    root, jparams, jstate = jax_training_ckpt
    _, cfg, _, tp = tp_.setup("granite-8b")
    opt = AdamW()
    (params, state), extras = CheckpointManager(root / "ckpt").restore(
        (tp, opt.init(tp)), device="cpu")
    assert isinstance(state, AdamWState) and extras == {"step": 0}
    assert state.step.ndim == 0 and state.step.dtype == torch.int32
    assert int(state.step) == 1
    want = jax.tree.leaves((jparams, jstate))
    got = tree_leaves(params) + [state.step] + tree_leaves(state.m) \
        + tree_leaves(state.v)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        b = b.view(torch.int16).numpy().view(np.uint16) \
            if b.dtype == torch.bfloat16 else b.numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    CheckpointManager(tmp_path / "port").save(0, (params, state),
                                              {"step": 0})
    assert _files(tmp_path / "port") == _files(root / "ckpt")
    (p2, s2), _ = JManager(tmp_path / "port").restore((jparams, jstate))
    for a, b in zip(jax.tree.leaves((p2, s2)), want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_deploy_takes_a_jax_training_checkpoint(jax_training_ckpt,
                                                tmp_path):
    """``run_deploy(ckpt_dir=<a JAX (params, AdamW) checkpoint>)`` writes
    the JAX deploy's bytes."""
    root, _, _ = jax_training_ckpt
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)             # the JAX deploy prints, writes out
        jstats = jdeploy.run_deploy("granite-8b", True, str(root / "ckpt"),
                                    str(tmp_path / "jax"))
    finally:
        os.chdir(cwd)
    tstats = tdeploy.run_deploy("granite-8b", True, str(root / "ckpt"),
                                str(tmp_path / "port"), device="cpu")
    assert tstats == jstats
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_production_is_refused(monkeypatch):
    """``production=True`` in one process (a world of one): the production
    mesh's size error, raised before any process group is made."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        ttrain.train("granite-8b", production=True, device="cpu")
    assert not torch.distributed.is_initialized()


def _options(main) -> set:
    seen = []

    def grab(self, *a, **kw):
        seen.append(self)
        raise SystemExit(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main()
    return {s for a in seen[0]._actions for s in a.option_strings}


def test_parser_takes_every_reference_option():
    ref, port = _options(jtrain.main), _options(ttrain.main)
    assert ref <= port
    assert port - ref == {"--device"}


def test_python_m_train_runs_on_the_cpu_and_refuses_production(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
            "3", "--batch", "2", "--seq", "16", "--device", "cpu"]
    run = subprocess.run(base + ["--ckpt", str(tmp_path / "ck")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("loss: ")
    assert CheckpointManager(tmp_path / "ck").latest_step() == 2
    prod = subprocess.run(base + ["--production"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert prod.returncode != 0
    assert "needs a world of 256 ranks" in prod.stderr
