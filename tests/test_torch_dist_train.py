"""Training over a ("data", "model") mesh, on 4 ``gloo`` ranks of a CPU
process group, against the reference's.

The reference runs once in a subprocess with 16 forced virtual devices
(``torch_dist_helpers.REFERENCE``): its jitted train step on a (2, 2) mesh
with ``in_shardings`` (params by ``param_specs``, ZeRO-1 moments by
``opt_state_specs``, the batch data-sharded) and the same
``out_shardings`` (the reference's own ``train()`` sets none, and over
more than one device its second step refuses the first's outputs), from
``PRNGKey(0)``'s init, whose params the port's ranks load through
``interop``. It runs with
``--xla_allow_excess_precision=false``: by default XLA drops the bf16
roundings inside its fusions, and the jitted step then parts from the
same step run op by op by 1.4e-3 in the loss and 2 % of a first moment's
largest element; with the flag the first step's loss and moments are the
op-by-op ones (the moments within 2.3e-7 of their largest).

Bounds: losses within ``loss_tol`` (1e-3; peak learning rate 1e-3, so a
gradient sign that the two packages' roundings split moves a param by
2e-3 at most). A first moment after one step (0.1 x the clipped
gradient) within ``MESH_TOL`` = 2^-5 of its leaf's largest element, and
each param within ``torch_train_parity``'s update rule. A mesh's bf16
products round where one device's do not: the row-parallel products (wo,
w_down) sum bf16 partials over "model", and each weight's gradient sums
bf16 partials over "data". Both packages do so, at places of their own:
the reference's (2, 2) moments part from its one-device step's by up to
2.2 % of a leaf's largest (attn/wo), the port's (2, 2) from its one-process
step's by 2.0 % (ffn/w_up), and the two (2, 2) steps by 2.45 % (ln2), past
the one-device bound of 2^-6; 2^-5 is the power of two above. On a (2, 1)
mesh (no "model" partials) the forward is the one-process one: the first
loss is bit-equal.

qwen3-moe's ``moe_apply`` takes ``data_group_count`` = 2 token groups on
the (2, 2) mesh (the reference's grouping), each with its own capacity:
one group drops other tokens, and the port's one-process (one group)
first loss parts from the reference's (2, 2) one by 7.7e-3, the port's
(2, 2) one by 2.6e-4, and the one-process step forced to two groups by
3.7e-5. After an update the routes are no longer held: a router near-tie
that a mesh's roundings split moves a whole expert, and over 30 batch
seeds (10..39) the reference's own (2, 2) and (2, 1) runs (two groups
each) part by up to 9.9e-3 in the second and third losses (all three
within 1e-3 on 6 seeds), the port's (2, 2) and the reference's by up to
1.54e-2 (on 4; at seed 10, the first, 3.3e-3). The first losses part too
where a first route meets a near-tie (over those seeds up to 8.2e-3 port
vs reference, 7.5e-3 the reference's (2, 2) vs its (2, 1)); seed 10, the
batch seed these tests were written with, has none there. So the first
loss is held to ``LOSS_TOL`` and the later ones to ``MOE_LATER_TOL`` =
2^-6.

Every reading above is ``scripts/mesh_parity_readings.py --seeds 10 40
--eager``'s.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_helpers as H
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget
from repro.launch import sharding as jsh
from repro.models import family_module as jfamily
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.grad_compress import \
    simulate_compressed_allreduce as j_simulate
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import family_module
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.grad_compress import simulate_compressed_allreduce
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import FaultPolicy

ROOT = Path(__file__).resolve().parents[1]
MESH_TOL = 2.0 ** -5            # of a leaf's largest element (docstring)
LOSS_TOL = 1e-3
MOE_LATER_TOL = 2.0 ** -6       # qwen3-moe's losses after an update


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's (2, 2) run (subprocess) and the port's (2, 2) steps
    (4 ranks), both written into one directory."""
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16 "
                         "--xla_allow_excess_precision=false")
    run = subprocess.run([sys.executable, "-c", H.REFERENCE, str(d),
                          str(ROOT / "tests")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    H.spawn("steps", d, timeout=240)
    return d


@pytest.fixture
def world_of_one():
    """A process group of one made by the port (``init_distributed``),
    torn down after, so that no later test of this process trains over a
    mesh."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _load(d: Path, name: str) -> dict:
    with np.load(d / name) as z:
        return {k: z[k] for k in z.files}


def _worst(a: dict, b: dict, pre: str) -> tuple[float, str]:
    worst, where = 0.0, ""
    for k in a:
        if k.startswith(pre):
            rel = float(np.abs(a[k] - b[k]).max()
                        / max(np.abs(b[k]).max(), 1e-30))
            if rel > worst:
                worst, where = rel, k
    return worst, where


def _params_close(got: dict, want: dict, lr: float) -> None:
    """``torch_train_parity.check_train_step``'s param rule after one step:
    every param within 2 lr + 2^-7 (|p| + lr) of the reference's, and one
    whose first moment has one sign in both within 2^-7 (|p| + lr) +
    lr 1e-9 (1/|m_a| + 1/|m_b|)."""
    for k in want:
        if not k.startswith("p/"):
            continue
        a, b = want[k], got[k]
        ma, mb = want["m/" + k[2:]], got["m/" + k[2:]]
        d = np.abs(a - b)
        big = (np.maximum(np.abs(a), np.abs(b)) + lr) * 2.0 ** -7
        assert d.max() <= 2 * lr + big.max(), k
        same = np.sign(ma) == np.sign(mb)
        with np.errstate(divide="ignore"):
            tol = big + lr * 1e-9 * (1 / np.abs(ma) + 1 / np.abs(mb))
        assert np.all(d[same] <= tol[same]), k


@functools.lru_cache(maxsize=None)
def _one_process(d: Path, arch: str, group_count=None) -> dict:
    """The port's one-process steps on the same params and batches, as a
    dump of ``case_steps``'s form; ``group_count`` forces the MoE's (one
    run a set of arguments: read, never changed)."""
    cfg = get_config(arch, smoke=True)
    with open(d / f"{arch}.init.pkl", "rb") as f:
        params = interop.params_from_numpy(pickle.load(f), device="cpu")
    opt = AdamW(lr=warmup_cosine(H.PEAK_LR, 2, 10))
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    out, losses = {}, []
    saved = sh.data_group_count
    if group_count is not None:
        sh.data_group_count = lambda n: group_count
    try:
        for i in range(H.STEPS):
            b = {k: torch.from_numpy(v)
                 for k, v in H.batch_np(cfg.vocab_size, i).items()}
            params, state, metrics = step(params, state, b)
            losses.append(float(metrics["loss"]))
            if i == 0:
                for pre, tree in (("p/", params), ("m/", state.m)):
                    for path, x in sh.leaves_with_path(tree):
                        out[pre + path] = x.float().clone().numpy()
    finally:
        sh.data_group_count = saved
    out["losses"] = np.array(losses)
    return out


# --- (c) granite-8b on a (2, 2) mesh -----------------------------------------

def test_granite_mesh_step_matches_the_reference(work):
    """Three steps' losses, and the first step's moments and params,
    against the reference's jitted (2, 2) step."""
    got = _load(work, "granite-8b.npz")
    want = _load(work, "granite-8b.ref.npz")
    assert np.all(np.abs(got["losses"] - want["losses"]) <= LOSS_TOL), \
        (got["losses"], want["losses"])
    assert sorted(got) == sorted(want)
    worst, where = _worst(got, want, "m/")
    assert worst <= MESH_TOL, (where, worst)
    _params_close(got, want, float(warmup_cosine(H.PEAK_LR, 2, 10)(
        torch.tensor(1))))


def test_granite_mesh_step_matches_one_process(work):
    """The same (2, 2) steps against the port's one-process step on the
    same params and batches."""
    got = _load(work, "granite-8b.npz")
    one = _one_process(work, "granite-8b")
    assert np.all(np.abs(got["losses"] - one["losses"]) <= LOSS_TOL)
    worst, where = _worst(got, one, "m/")
    assert worst <= MESH_TOL, (where, worst)
    _params_close(got, one, float(warmup_cosine(H.PEAK_LR, 2, 10)(
        torch.tensor(1))))


# --- (d) qwen3-moe on a (2, 2) mesh ------------------------------------------

def test_moe_mesh_step_groups_tokens_as_the_reference(work):
    """Two token groups on both sides; the first loss within ``LOSS_TOL``
    of the reference's and the later two within ``MOE_LATER_TOL`` (module
    docstring); and the grouping has teeth: the port's one-process step
    (one group) parts from the reference's first loss by more than 4x the
    bound, while the one-process step forced to two groups does not."""
    got = _load(work, "qwen3-moe-30b-a3b.npz")
    want = _load(work, "qwen3-moe-30b-a3b.ref.npz")
    assert list(got["groups"]) == [2] * H.STEPS
    assert int(want["groups"]) == 2
    gap = np.abs(got["losses"] - want["losses"])
    assert gap[0] <= LOSS_TOL and np.all(gap[1:] <= MOE_LATER_TOL), \
        (got["losses"], want["losses"])
    one = _one_process(work, "qwen3-moe-30b-a3b")
    assert abs(one["losses"][0] - want["losses"][0]) > 4 * LOSS_TOL
    two = _one_process(work, "qwen3-moe-30b-a3b", group_count=2)
    assert abs(two["losses"][0] - want["losses"][0]) <= LOSS_TOL


def test_data_mesh_first_loss_is_the_one_process_one(work):
    """On a (2, 1) mesh (2 ranks: no "model" partial sums) the forward is
    the one-process one: both archs' first losses bit-equal to the
    one-process step's, qwen3-moe's with its two token groups forced
    there (and the mesh's own count 2)."""
    d = work / "data21"
    d.mkdir()
    for arch in H.ARCHS:
        (d / f"{arch}.init.pkl").write_bytes(
            (work / f"{arch}.init.pkl").read_bytes())
    H.spawn("steps", d, world=2, timeout=240, mesh_shape=(2, 1))
    got = _load(d, "granite-8b.npz")
    assert got["losses"][0] == _one_process(work, "granite-8b")["losses"][0]
    got = _load(d, "qwen3-moe-30b-a3b.npz")
    assert list(got["groups"]) == [2] * H.STEPS
    two = _one_process(work, "qwen3-moe-30b-a3b", group_count=2)
    assert got["losses"][0] == two["losses"][0]


def test_moe_apply_groups_drop_other_tokens():
    """``moe_apply`` at 1 and 2 groups on the same 64 tokens: a capacity
    per group drops other assignments, so the outputs differ; at 1 group
    inside no mesh it is the one-group dispatch bit for bit."""
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    p = moe.moe_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5)).to(torch.bfloat16)
    one = moe.moe_apply(cfg, p, x)
    buf, meta = moe._dispatch_group(cfg, x.reshape(64, -1), p["router"],
                                    1.25, x.dtype)
    direct = moe._combine_group(moe._swiglu_bank(p["experts"], buf, x.dtype),
                                meta, cfg.d_model).reshape(x.shape)
    assert torch.equal(one, direct.to(x.dtype))
    saved = sh.data_group_count
    sh.data_group_count = lambda n: 2
    try:
        two = moe.moe_apply(cfg, p, x)
    finally:
        sh.data_group_count = saved
    assert not torch.equal(one, two)


# --- (b) compressed_psum -----------------------------------------------------

def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.numpy()


def test_compressed_psum_matches_the_simulation(tmp_path):
    """Over the (2, 2) mesh's data group: the mean within an f32 ulp of
    each element of the port's and the reference's
    ``simulate_compressed_allreduce`` on the two data ranks' trees, the
    new errors bit-equal; 20 steps of error feedback keep the accumulated
    mean within 2 % of the true one (tests/test_optim_data.py's rule)."""
    H.spawn("compress", tmp_path, timeout=120)
    runs = []
    for d in (0, 1):
        with open(tmp_path / f"compress-{d}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    assert all(r["group_size"] == 2 for r in runs)
    mean, errs = simulate_compressed_allreduce([r["g"] for r in runs],
                                               [r["e"] for r in runs])
    jmean, jerrs = j_simulate(
        [jax.tree.map(jnp.asarray, _np_tree(r["g"])) for r in runs],
        [jax.tree.map(jnp.asarray, _np_tree(r["e"])) for r in runs])
    for r, err, jerr in zip(runs, errs, jerrs):
        for path in ("a", "b/c"):
            keys = path.split("/")

            def at(t):
                for k in keys:
                    t = t[k]
                return np.asarray(t)
            got, want, jwant = at(r["mean"]), at(mean), at(jmean)
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
            assert np.all(np.abs(got - jwant) <= np.spacing(np.abs(jwant)))
            assert np.array_equal(at(r["err"]), at(err))
            assert np.array_equal(at(r["err"]), at(jerr))
    true_acc = np.zeros(64)
    comp_acc = np.zeros(64)
    for (g0, m0), (g1, m1) in zip(runs[0]["trace"], runs[1]["trace"]):
        assert np.array_equal(m0, m1)            # every rank the same mean
        true_acc += (g0.astype(np.float64) + g1) / 2
        comp_acc += m0
    rel = np.linalg.norm(comp_acc - true_acc) / np.linalg.norm(true_acc)
    assert rel < 0.02, rel


# --- (e) train() over a mesh, checkpoints and elastic re-meshing -------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train()`` over the 4 ranks' host mesh (4, 1), 6 steps with a
    checkpoint every 3, then again (nothing to do); then the checkpoint
    restored by ``remesh_restore`` onto ``plan_mesh(4, 2)`` over 4 ranks."""
    d = tmp_path_factory.mktemp("train")
    H.spawn("train", d, timeout=240, steps=6)
    H.spawn("remesh", d, timeout=120)
    with open(d / "train.pkl", "rb") as f:
        run = pickle.load(f)
    with open(d / "remesh.pkl", "rb") as f:
        remesh = pickle.load(f)
    return d, run, remesh


def _jtemplate():
    cfg = jget("granite-8b", smoke=True)
    params = jfamily(cfg.family).init(cfg, jax.random.PRNGKey(0))
    return params, JAdamW().init(params)


def test_mesh_train_checkpoint_is_the_reference_format(trained, tmp_path,
                                                      monkeypatch):
    """The (4, 1) run's checkpoint: its manifest is a one-process
    ``train()``'s but for the numbers, and it restores in the reference's
    ``CheckpointManager`` to the run's final state bit for bit (ZeRO-1
    moments sharded over "data" on the run, whole on disk)."""
    d, run, _ = trained
    assert run["mesh"] == (4, 1) and run["start"] == 0
    assert run["again"] == 6 and len(run["losses"]) == 6
    assert np.isfinite(run["losses"]).all()
    # embed (V, D) on "model" over V; ZeRO-1 puts "data" on D
    assert run["placements"]["0/embed"] == "(Replicate(), Shard(dim=0))"
    assert run["placements"]["1/m/embed"] == \
        "(Shard(dim=1), Shard(dim=0))"
    monkeypatch.setattr(ttrain, "FaultPolicy",
                        lambda: FaultPolicy(straggler_tolerance=10**9))
    ttrain.train("granite-8b", steps=6, ckpt_dir=str(tmp_path),
                 **H.TRAIN_KW)
    mesh_dir = CheckpointManager(d / "ckpt")
    one_dir = CheckpointManager(tmp_path)
    assert mesh_dir.latest_step() == one_dir.latest_step() == 5
    man = [json.loads((m._step_dir(5) / "manifest.json").read_text())
           for m in (mesh_dir, one_dir)]
    assert man[0] == man[1]
    state, extras = JCheckpointManager(d / "ckpt").restore(_jtemplate())
    assert extras == {"step": 5}
    want = run["state"]
    flat = jax.tree_util.tree_leaves_with_path(state)
    assert len(flat) == len(want)
    for path, x in flat:
        a = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
            else np.asarray(x)
        key = jsh._path_str(path)
        assert np.array_equal(a, want[key].float().numpy()
                              if want[key].is_floating_point()
                              else want[key].numpy()), key


def test_remesh_restore_moves_the_checkpoint_bit_for_bit(trained,
                                                         world_of_one):
    """``remesh_restore`` puts the (4, 1) run's checkpoint onto
    ``plan_mesh(4, prefer_model=2)`` = (2, 2) over the 4 ranks and onto
    ``plan_mesh(1)`` in this one process, each leaf bit-equal to the run's
    final state."""
    d, run, remesh = trained
    assert remesh["mesh"] == (2, 2) and remesh["step"] == 5
    assert remesh["names"] == ("data", "model")
    for k, (pl, x) in remesh["state"].items():
        assert torch.equal(x, run["state"][k]), k
    assert "Shard(dim=2)" in remesh["state"]["0/layers/ffn/w_up"][0]
    cfg = get_config("granite-8b", smoke=True)
    params = family_module(cfg.family).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    state, es = elastic.remesh_restore(
        CheckpointManager(d / "ckpt"), (params, AdamW().init(params)), 1,
        device="cpu")
    assert tuple(es.mesh.shape) == (1, 1) and es.step == 5
    for k, x in sh.leaves_with_path(state):
        assert torch.equal(x.full_tensor(), run["state"][k]), k


def test_restart_resumes_across_the_mesh_change(trained, tmp_path,
                                                monkeypatch):
    """The reference's ``test_train_restart_is_exact`` across meshes: the
    (4, 1) run's checkpoint (step 5) resumes in one process at step 6 with
    the run's final state bit for bit, and trains on."""
    import shutil
    d, run, _ = trained
    shutil.copytree(d / "ckpt", tmp_path / "ckpt")
    monkeypatch.setattr(ttrain, "FaultPolicy",
                        lambda: FaultPolicy(straggler_tolerance=10**9))
    restored = {}
    real = CheckpointManager.restore

    def spy(self, template, *a, **kw):
        out = real(self, template, *a, **kw)
        # copies: the steps that follow update the restored state in place
        restored.update((k, x.clone()) for k, x in
                        sh.leaves_with_path(out[0]))
        return out
    monkeypatch.setattr(CheckpointManager, "restore", spy)
    r = ttrain.train("granite-8b", steps=8, ckpt_dir=str(tmp_path / "ckpt"),
                     **H.TRAIN_KW)
    assert r["start_step"] == 6 and len(r["losses"]) == 2
    assert np.isfinite(r["losses"]).all()
    assert restored.keys() == run["state"].keys()
    for k, x in restored.items():
        assert torch.equal(x, run["state"][k]), k


def test_python_m_train_runs_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train`` under ``torchrun
    --standalone`` (2 ranks, ``gloo``, a rendezvous on a free localhost
    port): each rank joins the group, trains over the host mesh (2, 1),
    rank 0 prints the losses once and writes the checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--steps", "4", "--batch", "4", "--seq", "16", "--device", "cpu",
         "--ckpt", str(tmp_path / "ck")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert [line for line in run.stdout.splitlines()
            if line.startswith("loss: ")] == [run.stdout.strip()]
    assert CheckpointManager(tmp_path / "ck").latest_step() == 3


def test_elastic_plan_mesh(world_of_one):
    mesh = elastic.plan_mesh(1, prefer_model=16, device="cpu")
    assert mesh.size() == 1
    assert tuple(mesh.mesh_dim_names) == ("data", "model")


def test_elastic_remesh_restore(tmp_path, world_of_one):
    mgr = CheckpointManager(tmp_path)
    template = {"layers": {"ffn": {"w_up": torch.ones((4, 8))}},
                "embed": torch.ones((16, 4))}
    mgr.save(5, template, {"step": 5})
    state, es = elastic.remesh_restore(mgr, template, n_devices=1,
                                       device="cpu")
    assert es.step == 5
    assert torch.equal(state["embed"].full_tensor(), template["embed"])


def test_plan_grid_matches_the_reference(work):
    """The (data, model) grid for 1..16 devices at ``prefer_model`` 16
    and 2, against the reference's ``plan_mesh`` over as many devices."""
    ref = json.loads((work / "plan.json").read_text())
    for n in range(1, 17):
        for m in (16, 2):
            assert list(elastic.plan_grid(n, m)) == ref[f"{n},{m}"], (n, m)


# --- (f) the production meshes ------------------------------------------------

_FAKE = r'''
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, mesh as tmesh, sharding as sh
params = dryrun.build_params(get_config("granite-8b"), False)[0]
out = {}
for multi, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    out[str(multi)] = {
        "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
        "data": list(tmesh.data_axis_names(mesh)),
        "specs": [[p, [list(a) if isinstance(a, tuple) else a for a in s]]
                  for p, s in sh.leaves_with_path(
                      sh.param_specs(params, mesh))],
        "placements": str(sh.placements(
            sh.param_specs(params, mesh)["layers"]["ffn"]["w_up"], mesh))}
    dist.destroy_process_group()
print(json.dumps(out))
'''


def test_production_mesh_under_the_fake_backend():
    """(16, 16) ("data", "model") over a fake world of 256 and (2, 16, 16)
    ("pod", "data", "model") over 512, in a subprocess; granite-8b's
    full-size ``param_specs`` on each equal the reference's on the same
    shapes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    run = subprocess.run([sys.executable, "-c", _FAKE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = jget("granite-8b")
    jp = jax.eval_shape(lambda k: jfamily(cfg.family).init(cfg, k),
                        jax.random.PRNGKey(0))
    for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16),
                                 ("pod", "data", "model"))):
        got = out[str(multi)]
        assert tuple(got["shape"]) == shape
        assert tuple(got["names"]) == names
        assert tuple(got["data"]) == names[:-1]
        ref = sh.MeshShape(names, dict(zip(names, shape)))
        flat = jax.tree_util.tree_flatten_with_path(
            jsh.param_specs(jp, ref),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = [[jsh._path_str(p), [list(a) if isinstance(a, tuple) else a
                                    for a in s]] for p, s in flat]
        assert got["specs"] == want
        # w_up (L, D, F): F over "model", replicated on the data axes
        assert got["placements"] == (
            "[Replicate(), Shard(dim=2)]" if not multi
            else "[Replicate(), Replicate(), Shard(dim=2)]")


def test_production_mesh_refuses_a_world_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
