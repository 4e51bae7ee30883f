"""The port's ``CheckpointManager`` (``repro_torch/checkpoint/manager.py``)
against the reference's: tests/test_checkpoint_runtime.py's CPU cases on
the port, the ``treedef`` token equal to ``str(jax.tree_util.
tree_structure(...))`` over every kind of node the port writes, and the
on-disk format shared both ways — a checkpoint written by either package
restores in the other, and for the same tree and step ``manifest.json``
and ``arrays.npz`` are byte-equal (a deployed tree's parity included,
which the JAX package holds as uint32)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget
from repro.core import tiering as jtier
from repro.models import dense as jdense
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager, _treedef_token
from repro_torch.core import tiering as ttier


def _state(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4),
                                                      np.float32)) * scale,
            "opt": {"m": torch.zeros((8, 4)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, ttier.FlashWeight):
        return [tree.q, tree.parity, tree.scale]
    return [tree]


# --- tests/test_checkpoint_runtime.py:19-57 on the port ----------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state(0)
    mgr.save(10, state, {"step": 10})
    out, extras = mgr.restore(state, device="cpu")
    assert extras["step"] == 10
    for a, b in zip(_leaves(out), _leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(0, s))
    assert sorted(mgr.all_steps()) == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(7, _state(0), {"step": 7})
    mgr.wait()
    assert mgr.latest_step() == 7


def test_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(0))
    assert not list(tmp_path.glob(".tmp*"))
    assert (tmp_path / "LATEST").read_text().strip() == "step_00000001"


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(0))
    with pytest.raises(ValueError):
        mgr.restore({"different": torch.zeros(3)}, device="cpu")


# --- the treedef token --------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    """granite-8b-smoke's JAX init params and the port's copy of them."""
    jp = jdense.init(jget("granite-8b", smoke=True), jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _flash_pair(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8), np.float32)
    jfw = jtier.encode_flash(jnp.asarray(w, jnp.bfloat16))
    return jfw, interop.flash_from_numpy(jax.tree.map(np.asarray, jfw),
                                         device="cpu")


def _trees(kind, granite):
    """(JAX tree, port tree) of one structure."""
    z, t = jnp.zeros((2, 3)), torch.zeros((2, 3))
    if kind == "nested_dicts":
        return ({"b": {"y": z, "x": {}}, "a": z},
                {"b": {"y": t, "x": {}}, "a": t})
    if kind == "tuple_list_none":
        return ((z, [z, None], (z,)), (t, [t, None], (t,)))
    if kind == "zero_d_leaf":
        return ({"step": jnp.int32(3)},
                {"step": torch.tensor(3, dtype=torch.int32)})
    if kind == "flash_weight":
        jfw, tfw = _flash_pair(0)
        return {"w": jfw, "n": None}, {"w": tfw, "n": None}
    jp, tp = granite
    if kind == "granite_deploy":
        return jtier.deploy(jp)[0], ttier.deploy(tp)[0]
    if kind == "granite_dram_tier":
        return jtier.dram_tier(jp), ttier.dram_tier(tp)
    raise KeyError(kind)


KINDS = ["nested_dicts", "tuple_list_none", "zero_d_leaf", "flash_weight",
         "granite_deploy", "granite_dram_tier"]


@pytest.mark.parametrize("kind", KINDS)
def test_treedef_token_is_jax_tree_structure_string(kind, granite):
    jtree, ttree = _trees(kind, granite)
    assert _treedef_token(ttree) == str(jax.tree_util.tree_structure(jtree))


# --- the on-disk format, both ways -------------------------------------------

def _deployed_pair(granite):
    jp, tp = granite
    jt = jtier.deploy(jp, rber=1e-3, seed=2)[0]
    tt = ttier.deploy(tp, rber=1e-3, seed=2)[0]
    assert jt["lm_head"].parity.dtype == jnp.uint32
    assert tt["lm_head"].parity.dtype == torch.uint8
    return jt, tt


@pytest.mark.parametrize("kind", ["state", "granite_deploy",
                                  "granite_dram_tier"])
def test_both_packages_write_the_same_bytes(kind, granite, tmp_path):
    if kind == "state":
        jtree = {"w": jnp.asarray(np.arange(32, dtype=np.float32)
                                  .reshape(8, 4)),
                 "opt": {"m": jnp.ones((8, 4), jnp.bfloat16),
                         "step": jnp.int32(3)}}
        ttree = interop.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                          device="cpu")
    elif kind == "granite_deploy":
        jtree, ttree = _deployed_pair(granite)
    else:
        jtree, ttree = _trees(kind, granite)
    extras = {"arch": "granite-8b", "rber": 1e-3, "flash_bytes": 12}
    JManager(tmp_path / "jax").save(5, jtree, extras)
    CheckpointManager(tmp_path / "port").save(5, ttree, extras)
    for name in ("manifest.json", "arrays.npz"):
        assert ((tmp_path / "port" / "step_00000005" / name).read_bytes()
                == (tmp_path / "jax" / "step_00000005" / name).read_bytes())
    assert ((tmp_path / "port" / "LATEST").read_bytes()
            == (tmp_path / "jax" / "LATEST").read_bytes())


def _equal(port_tree, jax_tree):
    pl, jl = _leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        if p.dtype == torch.bfloat16:
            assert j.dtype.name == "bfloat16"
            p, j = p.view(torch.int16).numpy(), j.view(np.int16)
        elif p.dtype == torch.uint8 and j.dtype == np.uint32:   # parity
            j = j.astype(np.uint8)
            p = p.numpy()
        else:
            p = p.numpy()
            assert p.dtype == j.dtype
        np.testing.assert_array_equal(p, j)


def test_a_checkpoint_restores_in_the_other_package(granite, tmp_path):
    jt, tt = _deployed_pair(granite)
    # JAX writes, the port restores (parity narrowed to uint8) ...
    JManager(tmp_path / "jax").save(3, jt, {"step": 3})
    got, extras = CheckpointManager(tmp_path / "jax").restore(tt,
                                                              device="cpu")
    assert extras == {"step": 3}
    assert got["lm_head"].parity.dtype == torch.uint8
    _equal(got, jt)
    # ... and the port writes, JAX restores (parity uint32 again)
    CheckpointManager(tmp_path / "port").save(3, tt, {"step": 3})
    back, extras = JManager(tmp_path / "port").restore(jt)
    assert extras == {"step": 3}
    assert back["lm_head"].parity.dtype == jnp.uint32
    _equal(tt, back)
    # a JAX-written tree the port's template does not match is refused
    with pytest.raises(ValueError, match="structure mismatch"):
        CheckpointManager(tmp_path / "jax").restore(ttier.dram_tier(
            granite[1]), device="cpu")
