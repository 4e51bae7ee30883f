"""The port's dry-run shapes (``repro_torch.configs.shapes``) against the
reference's: the 40 (arch x shape) cells with their skip rule, and every
batch and cache spec (meta tensors in the port, ``jax.ShapeDtypeStruct``s
in the reference) equal in shape and dtype, at full size and at smoke."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro_torch.configs import (ARCHS, SHAPES, applicable, batch_specs,
                                 cache_specs, get_config)

CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def test_input_specs_all_cells():
    """Every (arch x shape) cell defines coherent specs (40 cells): the
    scenario of tests/test_integration.py on the port."""
    n_live = n_skip = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = applicable(cfg, shape)
            if not ok:
                n_skip += 1
                assert "quadratic" in why
                continue
            n_live += 1
            b = batch_specs(cfg, shape)
            assert all(hasattr(v, "shape") for v in b.values())
            if shape.kind == "decode":
                c = cache_specs(cfg, shape)
                assert len(c) > 0
    assert n_live + n_skip == 40
    assert n_skip == 8          # long_500k skipped for 8 full-attention archs


def test_shape_set_equals_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    from repro.configs.shapes import SMOKE_OVERRIDES as jsmoke
    from repro_torch.configs.shapes import SMOKE_OVERRIDES
    assert SMOKE_OVERRIDES == jsmoke


def _same_specs(ours: dict, ref: dict):
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(ref[k].dtype), k


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_equal_the_reference(arch, shape, smoke):
    cfg, jcfg = get_config(arch, smoke), jconfigs.get_config(arch, smoke)
    spec, jspec = SHAPES[shape], jconfigs.SHAPES[shape]
    ok, why = applicable(cfg, spec)
    assert (ok, why) == jconfigs.applicable(jcfg, jspec)
    if not ok:
        return
    _same_specs(batch_specs(cfg, spec, smoke=smoke),
                jconfigs.batch_specs(jcfg, jspec, smoke=smoke))
    if spec.kind == "decode":
        _same_specs(cache_specs(cfg, spec, smoke=smoke),
                    jconfigs.cache_specs(jcfg, jspec, smoke=smoke))
