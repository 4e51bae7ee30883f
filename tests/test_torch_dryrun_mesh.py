"""The dry-run's production meshes (``launch/dryrun.py`` mesh cells,
``launch/cost.py`` under a mesh, ``launch/roofline.collective_bw``,
``launch/report.collectives_table``).

The fake-world cases run in one subprocess (``_FAKE``), since a process
group is global to its process: (a) each collective DTensor issues for a
few redistributions on a (2, 2) mesh, charged by ``hlo_cost``'s wire rule,
and two kernel boundaries' mesh rules;
(c) granite-8b's full-size ``train_4k`` cell on 16x16 and 2x16x16 (FSDP,
ZeRO-1) and its ``decode_32k`` cell on 16x16, whose argument bytes per
chip are held here to the reference's specs on ``jax.eval_shape`` trees;
(d) smoke cells on a (1, 1) mesh against the one-card cells; (e) the fake
(2, 2) count of granite-8b's smoke ``train_4k`` cell. (e)'s real side is
one step of the same cell on 4 ``gloo`` ranks (``torch_dist_helpers``'
``case_collectives``), counted by the same mode on real tensors. (b)
needs no world: the spec functions read a ``MeshShape``. (f) runs the
command line at smoke size over both meshes.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import pytest

import torch_dist_helpers as H
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.configs import batch_specs as jbatch_specs
from repro.configs import cache_specs as jcache_specs
from repro.configs import get_config as jget
from repro.core.tiering import deploy as jdeploy
from repro.launch import sharding as jsh
from repro.models import family_module as jfamily
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import cost, dryrun, report
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}

_FAKE = r'''
import json, sys
import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from repro_torch.configs import get_config
from repro_torch.launch import cost, dryrun
from repro_torch.launch import sharding as sh

out = {"a": {}, "c": {}, "d": {}}
with dryrun.mesh_world(mesh_shape=(2, 2)) as dm:
    def placed(shape, pls):
        local = list(shape)
        for i, p in enumerate(pls):
            if p.is_shard():
                local[p.dim] //= dm.size(i)
        return sh.from_shard(torch.empty(local, device="meta"), dm, pls)
    cases = {"all-reduce": ([Replicate(), Partial()], [Replicate()] * 2),
             "all-gather": ([Shard(0), Replicate()], [Replicate()] * 2),
             "reduce-scatter": ([Replicate(), Partial()],
                                [Replicate(), Shard(0)])}
    for kind, (src, dst) in cases.items():
        got = cost.count(lambda t: t.redistribute(dm, dst),
                         placed((8, 64), src), skip_fake=True)
        out["a"][kind] = {"wire": got.cost.wire,
                          "collectives": got.cost.collectives,
                          "n": got.cost.n_collectives,
                          "bytes": got.cost.bytes}
    from repro_torch.kernels import decode_attn, grouped_ecdp, paged_ecdp
    out["rules"] = {}
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    for name, mod, args in (
            ("decode_attn_plain", decode_attn,
             (placed((4, 2, 2, 16), [Shard(0), Shard(1)]),
              placed((4, 32, 2, 16), [Shard(0), Shard(2)]),
              placed((4, 32, 2, 16), [Shard(0), Shard(2)]),
              placed((4,), [Shard(0), Replicate()]))),
            ("grouped_ecdp_plain", grouped_ecdp,
             (placed((8, 32), [Replicate(), Replicate()]),
              placed((5,), [Replicate(), Replicate()]),
              placed((4, 32, 16), [Replicate(), Shard(0)]),
              placed((4, 4, 16), [Replicate(), Shard(0)]),
              placed((4, 1, 16), [Replicate(), Shard(0)]))),
            ("paged_ecdp_matmul_plain", paged_ecdp,
             (placed((8, 128), [Shard(0), Replicate()]), meta(3, 16384),
              meta(1, 1), meta(1), meta(1), (128, 128)))):
        got = cost.count(lambda *t: getattr(mod, name)(*t), *args,
                         skip_fake=True)
        first = got.out[0] if isinstance(got.out, tuple) else got.out
        out["rules"][name] = {
            "boundaries": got.boundaries, "flops": got.cost.flops,
            "n": got.cost.n_collectives, "shape": list(first.shape),
            "local": list(first.to_local().shape),
            "placements": [repr(p) for p in first.placements]}
for name, shape in (("16x16", "train_4k"), ("2x16x16", "train_4k"),
                    ("16x16", "decode_32k")):
    r = dryrun.run_cell("granite-8b", shape, mesh=name)
    out["c"][f"{name}/{shape}"] = {k: r.get(k) for k in (
        "status", "error", "memory", "n_collectives", "collectives",
        "roofline")}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    one = dryrun.count_cell("granite-8b", shape, smoke=True)
    mesh = dryrun.count_cell("granite-8b", shape, smoke=True,
                             mesh_shape=(1, 1))
    params = dryrun.build_params(get_config("granite-8b", smoke=True),
                                 shape != "train_4k")[0]
    out["d"][shape] = {
        k: {"flops": g["cost"].flops, "bytes": g["cost"].bytes,
            "n": g["cost"].n_collectives, "wire": g["cost"].wire,
            "args": g["argument_bytes"]} for k, g in (("card", one),
                                                      ("1x1", mesh))}
    out["d"][shape]["param_bytes"] = sum(
        t.untyped_storage().nbytes() for _, t in sh.leaves_with_path(params))
e = dryrun.count_cell("granite-8b", "train_4k", smoke=True,
                      knobs=dict(n_micro=1), mesh_shape=(2, 2))
out["e"] = {"collectives": e["cost"].collectives, "wire": e["cost"].wire,
            "n_collectives": e["cost"].n_collectives}
print(json.dumps(out))
'''


def _start(args: list) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    return subprocess.Popen([sys.executable] + args, env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The two subprocesses, started together when the module's first
    test needs either, so that they run beside each other and beside the
    4-rank step and the reference's side in this process: ``_FAKE`` and
    the command line over every smoke cell on both meshes (4 workers)."""
    out = tmp_path_factory.mktemp("dryrun_mesh")
    procs = {"fake": _start(["-c", _FAKE]),
             "cli": _start(["-m", "repro_torch.launch.dryrun", "--smoke",
                            "--mesh", "both", "--jobs", "4", "--out",
                            str(out)])}
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish(proc: subprocess.Popen, timeout: float):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, stdout, stderr


@pytest.fixture(scope="module")
def fake(started):
    rc, stdout, stderr = _finish(started[0]["fake"], 420)
    assert rc == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


# --- (a) the wire rule by hand ---------------------------------------------------

# on the (2, 2) mesh an (8, 64) f32 tensor: 2048 bytes whole, 1024 a shard
WIRE_BY_HAND = {
    "all-reduce": 2 * 2048,                  # 2 x the result
    "all-gather": max(2048 - 1024, 1024),    # max(result - operand, operand)
    "reduce-scatter": 2048,                  # the operand
}


@pytest.mark.parametrize("kind", list(WIRE_BY_HAND))
def test_wire_rule_by_hand(fake, kind):
    got = fake["a"][kind]
    assert got["wire"] == {kind: WIRE_BY_HAND[kind]}
    assert got["collectives"] == {kind: 1} and got["n"] == 1
    result = 1024 if kind == "reduce-scatter" else 2048
    assert got["bytes"] >= result            # the collective's result bytes


# the kernels' boundaries under the (2, 2) mesh: (flops, global shape,
# local shape, placements) of the first output
RULES = {
    # each chip its (B, KV) shard: 2 rows x 1 KV head x 2 x 32 keys x 16
    "decode_attn_plain": (4 * 2 * 1 * 2 * 32 * 16, [4, 2, 2, 16],
                          [2, 1, 2, 16], ["Shard(dim=0)", "Shard(dim=1)"]),
    # experts over "model": each chip its 2 of 4 experts' share of the rows
    "grouped_ecdp_plain": (2 * 8 * 32 * 16 / 2, [8, 16], [8, 16],
                           ["Replicate()", "Partial(sum)"]),
    # the page pool whole on every chip, each chip its own rows
    "paged_ecdp_matmul_plain": (2 * 4 * 128 * 128, [8, 128], [4, 128],
                                ["Shard(dim=0)", "Replicate()"]),
}


@pytest.mark.parametrize("name", list(RULES))
def test_kernel_boundaries_under_a_mesh(fake, name):
    got = fake["rules"][name]
    flops, shape, local, pls = RULES[name]
    assert got["boundaries"] == {name: 1} and got["n"] == 0
    assert (got["flops"], got["shape"], got["local"], got["placements"]) == \
        (flops, shape, local, pls)


@pytest.mark.parametrize("op,operand,result,wire", [
    ("all-reduce", 100, 100, 200), ("reduce-scatter", 400, 100, 400),
    ("all-gather", 100, 1600, 1500), ("all-gather", 100, 150, 100),
    ("all-to-all", 100, 100, 100), ("collective-permute", 64, 64, 64)])
def test_wire_bytes_follow_hlo_cost(op, operand, result, wire):
    assert cost.wire_bytes(op, operand, result) == wire


def test_collective_bandwidth_by_node_layout():
    """Eight consecutive ranks a node: a group inside one node runs at
    NVLink's rate, one that spans nodes at the NIC's."""
    assert rl.collective_bw(None) == rl.LINK_BW
    assert rl.collective_bw((1, 1)) == rl.LINK_BW
    assert rl.collective_bw((2, 2)) == rl.LINK_BW
    assert rl.collective_bw((1, 8)) == rl.LINK_BW
    assert rl.collective_bw((2, 8)) == rl.NIC_BW      # "data" spans nodes
    assert rl.collective_bw((16, 16)) == rl.NIC_BW
    assert rl.collective_bw((2, 16, 16)) == rl.NIC_BW
    t = rl.roofline_terms(0.0, 0.0, {"all-reduce": 50e9}, 256, 0.0,
                          link_bw=rl.NIC_BW)
    assert t["collective_s"] == 1.0 and t["dominant"] == "collective_s"


# --- (b) the deployed tree's specs -------------------------------------------------

def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jsh._path_str(p), x) for p, x in flat]


def _as_lists(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_deployed_specs_equal_the_reference(mesh):
    """granite-8b's deployed (tiered) full-size tree: the port's
    ``param_specs`` leaf for leaf the reference's on ``jax.eval_shape`` of
    its deploy (FlashWeight planes included)."""
    names, shape = MESHES[mesh]
    ms = sh.MeshShape(names, dict(zip(names, shape)))
    cfg = jget("granite-8b")
    jp = jax.eval_shape(partial(jfamily(cfg.family).init, cfg),
                        jax.random.PRNGKey(0))
    jd = jax.eval_shape(lambda p: jdeploy(p)[0], jp)
    want = [(p, _as_lists(s)) for p, s in _ref_leaves(jsh.param_specs(jd, ms))]
    port = dryrun.build_params(get_config("granite-8b"), True)[0]
    got = [(p, _as_lists(s)) for p, s in sh.leaves_with_path(
        sh.param_specs(port, ms))]
    assert got == want
    assert any(p.endswith("ffn/w_up/1") for p, _ in got)


# --- (c) argument bytes per chip, exactly ---------------------------------------

def _local_bytes(leaves_specs, ms) -> int:
    """The bytes of each leaf's local shard under its spec, summed. The
    reference's parity planes are uint32 with one parity byte an element
    (``repro/core/ecc.py:90-96``); the port keeps that byte (uint8), so a
    parity plane counts one byte an element."""
    total = 0
    for path, leaf, spec in leaves_specs:
        n = 1
        for d, size in enumerate(leaf.shape):
            axes = spec[d] if d < len(spec) else None
            axes = () if axes is None else (
                axes if isinstance(axes, tuple) else (axes,))
            n *= size // math.prod(ms.shape[a] for a in axes)
        itemsize = (1 if re.search(r"/1$", path) and leaf.dtype.name ==
                    "uint32" else leaf.dtype.itemsize)
        total += n * itemsize
    return total


def _zip(tree, specs):
    got = dict(_ref_leaves(specs))
    return [(p, x, got[p]) for p, x in _ref_leaves(tree)]


def _reference_arguments(name: str, shape_name: str) -> int:
    names, shape = MESHES[name]
    ms = sh.MeshShape(names, dict(zip(names, shape)))
    cfg = jget("granite-8b")
    shape = JSHAPES[shape_name]
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(partial(jfamily(cfg.family).init, cfg), key)
    batch = jbatch_specs(cfg, shape)
    parts = [_zip(batch, jsh.batch_specs(batch, ms))]
    if shape.kind == "train":
        pspecs = jsh.param_specs(params, ms, fsdp=True)
        state = jax.eval_shape(JAdamW(moment_dtype="float32").init, params)
        parts += [_zip(params, pspecs), _zip(state, jsh.opt_state_specs(
            state, pspecs, ms, zero1=True))]
    else:
        params = jax.eval_shape(lambda p: jdeploy(p)[0], params)
        cache = jcache_specs(cfg, shape)
        parts += [_zip(params, jsh.param_specs(params, ms)),
                  _zip(cache, jsh.cache_specs(cache, ms))]
    return sum(_local_bytes(p, ms) for p in parts)


@pytest.mark.parametrize("cell", ["16x16/train_4k", "2x16x16/train_4k",
                                  "16x16/decode_32k"])
def test_argument_bytes_per_chip_equal_the_reference_specs(fake, cell):
    got = fake["c"][cell]
    assert got["status"] == "ok", got["error"]
    name, shape = cell.split("/")
    assert got["memory"]["argument_size_in_bytes"] == \
        _reference_arguments(name, shape)
    # every collective of a production mesh crosses nodes
    rf = got["roofline"]
    assert got["n_collectives"] > 0 and rf["wire_bytes_per_chip"] > 0
    assert rf["collective_s"] == rf["wire_bytes_per_chip"] / rl.NIC_BW
    assert sum(got["collectives"].values()) == round(got["n_collectives"])
    assert set(got["collectives"]) == set(rf["collectives_by_op"])


# --- (d) a (1, 1) mesh ------------------------------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_one_by_one_mesh_counts_the_one_card_step(fake, shape):
    """No collective, the one-card cell's flops and arguments; its bytes
    too, but for the one op DTensor adds: ``steps.grads_like`` makes a
    DTensor's zero gradients with ``zeros_like``, which is charged the read
    of the param it is shaped like (the plain path's ``zeros`` reads
    nothing)."""
    got = fake["d"][shape]
    card, mesh = got["card"], got["1x1"]
    assert mesh["n"] == 0 and mesh["wire"] == {}
    assert mesh["flops"] == card["flops"]
    assert mesh["args"] == card["args"]
    extra = got["param_bytes"] if shape == "train_4k" else 0
    assert mesh["bytes"] - card["bytes"] == extra


# --- (e) the fake count against a real 4-rank step --------------------------------

@pytest.fixture(scope="module")
def real(started, tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    H.spawn("collectives", d, timeout=240)
    return json.loads((d / "collectives.json").read_text())


def test_fake_count_equals_a_real_gloo_step(fake, real):
    assert real["n_collectives"] > 0
    assert fake["e"]["collectives"] == real["collectives"]
    assert fake["e"]["wire"] == real["wire"]
    assert fake["e"]["n_collectives"] == real["n_collectives"]


# --- (f) every smoke cell through the command line -------------------------------

@pytest.fixture(scope="module")
def smoke_cli(started):
    return _finish(started[0]["cli"], 600), started[1]


def test_every_smoke_cell_counts_on_both_meshes(smoke_cli):
    (rc, stdout, stderr), out = smoke_cli
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    for arch in ARCHS:
        for name in SHAPES:
            ok, reason = japplicable(jget(arch, smoke=True), JSHAPES[name])
            for mesh in MESHES:
                r = json.loads((out / f"{arch}_{name}_{mesh}_smoke.json")
                               .read_text())
                assert r["mesh"] == mesh
                if ok:
                    assert r["status"] == "ok", (arch, name, mesh,
                                                 r.get("error"))
                    assert r["roofline"]["collective_s"] >= 0
                else:
                    assert (r["status"], r["reason"]) == ("skipped", reason)


def test_report_renders_the_mesh_cells(smoke_cli, tmp_path, capsys):
    _, out = smoke_cli
    for f in out.glob("granite-8b_*_smoke.json"):
        (tmp_path / f.name.replace("_smoke", "")).write_text(f.read_text())
    rows = report.load(str(tmp_path))
    assert len(rows) == 8
    table = report.collectives_table(rows)
    assert table.count("\n") == 1 + 6            # 3 counted shapes x 2 meshes
    assert "all-reduce GiB" in table
    sys.argv = ["report", str(tmp_path)]
    report.main()
    printed = capsys.readouterr().out
    assert "### Roofline (16x16)" in printed
    assert "### Roofline (2x16x16)" in printed
    assert "### Collectives (per chip, mesh cells)" in printed
