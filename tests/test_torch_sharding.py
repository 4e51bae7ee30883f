"""The port's training specs (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): the scenarios of
tests/test_sharding.py on the port, then every leaf's spec of the ten
archs' params (bf16 and tiered), ZeRO-1 moments, batches and caches
compared path by path with the reference's on a (2, 2) ("data", "model")
mesh. Pure Python: the spec functions read only ``mesh.axis_names`` and
``mesh.shape``, so the port is given a ``MeshShape`` and the reference a
mesh over one CPU device repeated; no process group is made."""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget
from repro.configs import shapes as jshapes
from repro.core.tiering import deploy as jdeploy
from repro.launch import sharding as jsh
from repro.models import family_module as jfamily
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import ARCHS, SHAPES, get_config, shapes
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import P
from repro_torch.optim import AdamW

MESH = sh.MeshShape(("data", "model"), {"data": 2, "model": 2})
JMESH = jax.sharding.Mesh(np.array(jax.devices()[:1] * 4).reshape(2, 2),
                          ("data", "model"))


def _jpath(path) -> str:
    return jsh._path_str(path)


def _jspecs(tree):
    """[(path, spec as a tuple)] of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(_jpath(p), tuple(s)) for p, s in flat]


def _specs(tree):
    """[(path, spec as a tuple)] of a port spec tree."""
    return [(p, tuple(s)) for p, s in sh.leaves_with_path(tree)]


# --- the reference's scenarios ----------------------------------------------

def test_guard_drops_non_divisible():
    assert sh.guard((3, 64), P("model", "data"), MESH, "t") == P(None, "data")
    assert sh.guard((4, 63), P("model", "data"), MESH, "t") == P("model", None)


def test_guard_handles_tuples_and_missing_axes():
    assert sh.guard((8,), P(("pod", "data")), MESH, "t") == P("data")
    assert sh.guard((7,), P(("pod", "data")), MESH, "t") == P(None)


def test_param_rules():
    cases = {
        "embed": ((512, 64), P("model", None)),
        "lm_head": ((64, 512), P(None, "model")),
        "layers/attn/wq": ((2, 64, 128), P(None, None, "model")),
        "layers/attn/wo": ((2, 128, 64), P(None, "model", None)),
        "layers/ffn/w_gate": ((2, 64, 256), P(None, None, "model")),
        "layers/ffn/w_down": ((2, 256, 64), P(None, "model", None)),
        "layers/moe/experts/w_up": ((2, 8, 64, 32),
                                    P(None, "model", None, None)),
        "layers/moe/router": ((2, 64, 8), P(None, None, None)),
        "layers/ln1": ((2, 64), P(None, None)),
    }
    for path, (shape, want) in cases.items():
        got = sh.spec_for_param(path, shape, MESH)
        assert got == want, (path, got, want)
        assert tuple(got) == tuple(jsh.spec_for_param(path, shape, JMESH))


def test_fsdp_adds_data_axis():
    got = sh.spec_for_param("layers/ffn/w_gate", (2, 64, 256), MESH,
                            fsdp=True, data_axes=("data",))
    assert got == P(None, ("data",), "model")


def test_flash_weight_children_inherit_rule():
    assert sh.spec_for_param("layers/ffn/w_down/0", (2, 256, 64), MESH) == \
        P(None, "model", None)
    assert sh.spec_for_param("layers/ffn/w_down/1", (2, 32, 64), MESH) == \
        P(None, "model", None)
    assert sh.spec_for_param("layers/ffn/w_down/2", (2, 1, 64), MESH) == \
        P(None, None, None)                  # guard drops on dim=1


def test_batch_and_cache_specs():
    assert sh.batch_spec((8, 64), MESH) == P(("data",), None)
    assert sh.batch_spec((), MESH) == P()
    assert sh.cache_spec("k", (4, 8, 64, 2, 16), MESH) == \
        P(None, ("data",), "model", None, None)
    assert sh.cache_spec("wkv", (4, 8, 2, 16, 16), MESH) == \
        P(None, ("data",), None, None, None)


def test_constrain_noop_outside_mesh():
    """Outside ``use_mesh`` (and on a plain tensor) the hints are the
    identity: the same tensor comes back, and ``data_group_count`` is 1."""
    x = torch.ones((4, 4))
    assert sh.constrain(x, "data", None) is x
    assert sh.constrain_spec(x, P("data", None)) is x
    assert sh.pin_grad(x, ("data", None)) is x
    assert sh.data_group_count(64) == 1
    assert sh.whole(x) is x and sh.like(x, x) is x


def test_opt_state_specs_zero1():
    params = {"layers": {"ffn": {"w_gate": torch.zeros((4, 64, 256))}}}
    pspecs = sh.param_specs(params, MESH)
    ospecs = sh.opt_state_specs(AdamW().init(params), pspecs, MESH,
                                zero1=True)
    assert ospecs.m["layers"]["ffn"]["w_gate"] == \
        P(("data",), None, "model")          # data on the first free dim
    assert ospecs.step == P()
    plain = sh.opt_state_specs(AdamW().init(params), pspecs, MESH)
    assert plain.v["layers"]["ffn"]["w_gate"] == P(None, None, "model")


def test_spec_type_and_paths():
    """``P`` compares by its entries and iterates as them; the tree walk
    keys a NamedTuple by field, a list / tuple by index and a FlashWeight's
    children 0 / 1 / 2, as the reference's ``_path_str``."""
    assert P("data", None) == P(("data",), None) != P(None, "data")
    assert tuple(P(("pod", "data"), None)) == (("pod", "data"), None)
    assert len({P("a"), P("a")}) == 1
    st = AdamW().init({"w": torch.zeros((2, 3))})
    paths = [p for p, _ in sh.leaves_with_path((st, [torch.zeros(1)]))]
    assert paths == ["0/step", "0/m/w", "0/v/w", "1/0"]


# --- every arch's leaves against the reference's -----------------------------

def _port_params(arch: str, serving: bool):
    return dryrun.build_params(get_config(arch, smoke=True), serving)[0]


def _ref_params(arch: str, serving: bool):
    cfg = jget(arch, smoke=True)
    params = jax.eval_shape(partial(jfamily(cfg.family).init, cfg),
                            jax.random.PRNGKey(0))
    if serving:
        params = jax.eval_shape(lambda p: jdeploy(p)[0], params)
    return params


@pytest.mark.parametrize("tiered", [False, True], ids=["bf16", "tiered"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, tiered):
    """``param_specs`` (and with fsdp), path by path, of the smoke params
    bf16 and deployed."""
    tp, jp = _port_params(arch, tiered), _ref_params(arch, tiered)
    for fsdp in (False, True):
        got = _specs(sh.param_specs(tp, MESH, fsdp=fsdp))
        want = _jspecs(jsh.param_specs(jp, JMESH, fsdp=fsdp))
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_the_reference(arch):
    """ZeRO-1 and plain moments' specs of each arch's AdamW state."""
    tp, jp = _port_params(arch, False), _ref_params(arch, False)
    tstate = AdamW().init(tp)
    jstate = jax.eval_shape(JAdamW().init, jp)
    tps, jps = sh.param_specs(tp, MESH), jsh.param_specs(jp, JMESH)
    for zero1 in (True, False):
        got = _specs(sh.opt_state_specs(tstate, tps, MESH, zero1=zero1))
        want = _jspecs(jsh.opt_state_specs(jstate, jps, JMESH, zero1=zero1))
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch):
    """``batch_specs`` of every shape's batch and ``cache_specs`` of every
    decode shape's cache (``configs/shapes``, smoke sizes)."""
    cfg, jcfg = get_config(arch, smoke=True), jget(arch, smoke=True)
    for name, shape in SHAPES.items():
        jshape = jshapes.SHAPES[name]
        got = _specs(sh.batch_specs(shapes.batch_specs(cfg, shape, True),
                                    MESH))
        want = _jspecs(jsh.batch_specs(
            jshapes.batch_specs(jcfg, jshape, True), JMESH))
        assert got == want, name
        if shape.kind == "decode":
            got = _specs(sh.cache_specs(shapes.cache_specs(cfg, shape, True),
                                        MESH))
            want = _jspecs(jsh.cache_specs(
                jshapes.cache_specs(jcfg, jshape, True), JMESH))
            assert got == want, name
