"""The command line and the die-image deployment on the port
(``repro_torch.launch.deploy`` / ``repro_torch.launch.serve``), against
the reference's ``repro.launch`` on the CPU at smoke sizes:

  * ``run_deploy`` on both packages from the same params checkpoint writes
    the same die image, page table and checkpoint, byte for byte, and
    reports the same stats;
  * ``build_engine`` over a JAX-written die image (granite-8b-smoke's GQA,
    qwen3-32b-smoke's qk-norm) and ``build_engine("opt-tiny")`` on the JAX
    init's params (with and without speculative lanes) emit the JAX
    ``build_engine``'s greedy tokens;
  * ``serve`` returns the reference's keys and token counts; the
    refusals carry the reference's messages (and the port's own name the
    ROADMAP item that lifts them); the port's parsers take every option
    of the reference's; ``python -m`` runs both entry points.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget
from repro.launch import deploy as jdeploy
from repro.launch import serve as jserve
from repro.models import dense as jdense
from repro.serving.sampler import SampleConfig as JSample
from repro.store.faults import FaultConfig as JFaultConfig
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import deploy as tdeploy
from repro_torch.launch import serve as tserve
from repro_torch.models import dense as tdense
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleConfig
from repro_torch.store.faults import FaultConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# margin-scanned: every greedy token of these on the smoke archs clears
# its runner-up by >= 1e-3 (random-init near-ties, ROADMAP §C)
PROMPTS = [[5, 9, 2, 7], [11, 3, 3, 8, 1, 6], [200, 17, 42]]
MAX_NEW = 6


def _greedy(eng):
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    out = eng.run()
    eng.close()
    return [out[r] for r in rids]


def _params_ckpt(arch, path):
    """A params checkpoint of ``arch``-smoke's JAX init, JAX-written."""
    jp = jdense.init(jget(arch, smoke=True), jax.random.PRNGKey(0))
    JManager(path).save(0, jp)
    return jp


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """granite-8b-smoke deployed by both packages, from one JAX params
    checkpoint, with a die image (rber 1e-3) and without; each run in a
    directory of its own with the same relative paths, so the strings
    the checkpoints record are the same too."""
    root = tmp_path_factory.mktemp("deploy")
    _params_ckpt("granite-8b", root / "params")
    runs, cwd = {}, os.getcwd()
    for pkg, run in (("jax", jdeploy.run_deploy),
                     ("port", lambda *a, **k: tdeploy.run_deploy(
                         *a, device="cpu", **k))):
        for store in (False, True):
            d = root / pkg / ("store" if store else "plain")
            d.mkdir(parents=True)
            os.chdir(d)
            try:
                stats = run("granite-8b", True, str(root / "params"), "out",
                            rber=1e-3,
                            store_path="out/nand.img" if store else None)
            finally:
                os.chdir(cwd)
            runs[pkg, store] = (stats, d / "out")
    return runs


@pytest.mark.parametrize("store", [False, True], ids=["plain", "store"])
def test_deploy_writes_the_reference_bytes(deployed, store):
    (jstats, jout), (tstats, tout) = deployed["jax", store], \
        deployed["port", store]
    assert tstats == jstats
    jfiles, tfiles = _files(jout), _files(tout)
    names = {"LATEST", "step_00000000/manifest.json",
             "step_00000000/arrays.npz"}
    if store:
        names |= {"nand.img", "nand.img.meta.json"}
    assert set(tfiles) == set(jfiles) == names
    for name in sorted(names):
        assert tfiles[name] == jfiles[name], name


def test_deploy_refuses_a_training_checkpoint(tmp_path):
    """A (params, optimizer state) checkpoint whose state is not AdamW's
    restores as neither template, (params, AdamW state) nor params: both
    packages' deploys refuse it. (An AdamW training checkpoint deploys:
    tests/test_torch_train_launch.py.)"""
    jp = jdense.init(jget("granite-8b", smoke=True), jax.random.PRNGKey(0))
    JManager(tmp_path / "train").save(0, (jp, {"count": np.int32(0)}))
    with pytest.raises(ValueError, match="tree structure mismatch"):
        jdeploy.run_deploy("granite-8b", True, str(tmp_path / "train"),
                           str(tmp_path / "jout"))
    with pytest.raises(ValueError, match="tree structure mismatch"):
        tdeploy.run_deploy("granite-8b", True, str(tmp_path / "train"),
                           str(tmp_path / "out"), device="cpu")


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-32b"])
def test_build_engine_serves_a_jax_die_image(arch, tmp_path):
    """A die image + DRAM-tier checkpoint written by the JAX deploy, served
    by both packages' ``build_engine``: the same greedy tokens."""
    jdeploy.run_deploy(arch, True, None, str(tmp_path),
                       store_path=str(tmp_path / "nand.img"))
    img, ckpt = str(tmp_path / "nand.img"), str(tmp_path)
    want = _greedy(jserve.build_engine(arch, store_image=img, ckpt=ckpt,
                                       sample_cfg=JSample()))
    eng = tserve.build_engine(arch, store_image=img, ckpt=ckpt,
                              sample_cfg=SampleConfig(), device="cpu")
    assert eng.streamed and eng.store_preprogrammed
    assert _greedy(eng) == want


@pytest.fixture(scope="module")
def opt_tiny_params():
    return jdense.init(jserve.OPT_TINY, jax.random.PRNGKey(0))


@pytest.mark.parametrize("spec_k", [0, 2])
def test_build_engine_on_the_jax_init_emits_the_reference_tokens(
        spec_k, opt_tiny_params, monkeypatch):
    """``build_engine("opt-tiny")`` with the family's init handed the JAX
    init's params (the two packages' generators draw different numbers)."""
    np_params = jax.tree.map(np.asarray, opt_tiny_params)
    monkeypatch.setattr(tdense, "init",
                        lambda cfg, gen, device="cuda", sink=None:
                        interop.params_from_numpy(np_params, device))
    want = _greedy(jserve.build_engine("opt-tiny", spec_k=spec_k,
                                       sample_cfg=JSample()))
    got = _greedy(tserve.build_engine("opt-tiny", spec_k=spec_k,
                                      sample_cfg=SampleConfig(),
                                      device="cpu"))
    assert got == want


def test_serve_returns_the_reference_keys_and_counts():
    want = jserve.serve("opt-tiny", n_requests=3, max_new=4)
    got = tserve.serve("opt-tiny", n_requests=3, max_new=4, device="cpu")
    assert set(got) == set(want)
    assert got["tokens"] == want["tokens"] == 12
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    assert [len(o) for o in got["outputs"].values()] == [4, 4, 4]
    assert got["traces"] == 0                  # no graphs on the CPU
    assert set(got["stats"][0]) == set(want["stats"][0])


def _refusal(fn, **kw):
    with pytest.raises(SystemExit) as e:
        fn(**kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["family", "image_without_ckpt",
                                  "rber_with_image", "fault_without_store"])
def test_refusals_carry_the_reference_messages(case):
    kw = {"family": dict(arch="rwkv6-3b"),
          "image_without_ckpt": dict(store_image="nand.img"),
          "rber_with_image": dict(store_image="nand.img", ckpt="d",
                                  rber=1e-4)}.get(case)
    if case == "fault_without_store":
        want = _refusal(jserve.build_engine,
                        fault_cfg=JFaultConfig(read_rber=1e-5))
        got = _refusal(tserve.build_engine, device="cpu",
                       fault_cfg=FaultConfig(read_rber=1e-5))
    else:
        want = _refusal(jserve.build_engine, **kw)
        got = _refusal(tserve.build_engine, device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("kw,item", [
    (dict(arch="qwen3-moe-30b-a3b", stream=True), "§A.3"),
    (dict(arch="phi3.5-moe-42b-a6.6b", store_image="nand.img", ckpt="d"),
     "§A.3"),
    (dict(arch="qwen3-moe-30b-a3b", stream=True, shards=2), "§A.4")])
def test_what_the_port_lacks_names_its_roadmap_item(kw, item, tmp_path):
    """The items these cases named are ported. The streamed MoE plane
    (§A.3): ``stream=True`` and a MoE die image written by the port's
    ``deploy --store`` serve expert-paged, with the port's resident
    ``build_engine``'s greedy tokens (the same init;
    tests/test_torch_moe_engine.py holds them against the JAX package).
    ``--shards > 1`` on a MoE arch (§A.4's serving share;
    tests/test_torch_sharded_moe.py): over a mesh the engine takes the
    expert axis, and at smoke width qwen3's d_ff 32 is no whole 128-wide
    tile a shard, so it is refused loudly, never replicated; without a
    mesh the CPU has no second device."""
    if item == "§A.4":
        with pytest.raises(ValueError, match="cannot partition"):
            tserve.build_engine(device="cpu", mesh=["cpu"] * 2, **kw)
        assert "distinct cpu devices" in _refusal(tserve.build_engine,
                                                  device="cpu", **kw)
        return
    arch = kw["arch"]
    if "store_image" in kw:
        img = str(tmp_path / kw["store_image"])
        tdeploy.run_deploy(arch, True, None, str(tmp_path), store_path=img,
                           device="cpu")
        kw = dict(kw, store_image=img, ckpt=str(tmp_path))
    outs = []
    for args in (dict(arch=arch), kw):
        eng = tserve.build_engine(sample_cfg=SampleConfig(), device="cpu",
                                  **args)
        rid = eng.submit([5, 17, 29, 3], max_new=4)
        outs.append(eng.run()[rid])
        if eng.streamed:
            assert eng.streamed_moe
            assert eng.expert_stats()["expert_bytes_fetched"] > 0
        eng.close()
    assert outs[1] == outs[0] and len(outs[0]) == 4


def test_heads_no_kernel_takes_are_refused_at_build_on_the_card():
    """llama3-405b-smoke's head_dim 8: on the card the engine refuses it
    at construction (no plain fallback); on the CPU it serves through the
    plain versions, as does llava-next-34b-smoke's text backbone."""
    cfg = get_config("llama3-405b", smoke=True)
    with pytest.raises(ValueError, match="head_dim 8"):
        Engine(cfg, {}, device="cuda")
    for arch in ("llama3-405b", "llava-next-34b"):
        eng = tserve.build_engine(arch, sample_cfg=SampleConfig(),
                                  device="cpu")
        rid = eng.submit([1, 2, 3], max_new=3)
        assert len(eng.run()[rid]) == 3
        eng.close()


def _options(main) -> set[str]:
    """Every option string of the parser ``main`` builds."""
    seen = []

    def grab(self, *a, **k):
        seen.append(self)
        raise SystemExit(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main()
    return {s for a in seen[0]._actions for s in a.option_strings}


@pytest.mark.parametrize("mod", ["serve", "deploy"])
def test_port_parsers_take_every_reference_option(mod):
    ref = _options({"serve": jserve, "deploy": jdeploy}[mod].main)
    port = _options({"serve": tserve, "deploy": tdeploy}[mod].main)
    assert ref <= port
    assert port - ref == {"--device"}


def test_python_m_entry_points_run_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.deploy --store`` then ``serve
    --store-image --ckpt``, as a user runs them (``--device cpu``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tmp_path / "d"
    dep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.deploy", "--arch",
         "granite-8b", "--out", str(d), "--store", str(d / "nand.img"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=120)
    assert dep.returncode == 0, dep.stderr
    assert '"flash_leaves": 4' in dep.stdout
    srv = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--store-image", str(d / "nand.img"), "--ckpt",
         str(d), "--requests", "4", "--max-new", "8", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert srv.returncode == 0, srv.stderr
    assert "32 generated tokens" in srv.stdout
    assert "on cpu), step traces=-1" in srv.stdout
