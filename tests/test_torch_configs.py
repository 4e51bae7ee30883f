"""The port's arch registry (``repro_torch.configs``) against the
reference's: every arch's ``CONFIG`` and ``SMOKE`` field for field and in
its three parameter counts, ``ARCHS`` in order, and ``get_config``'s
refusal text."""
from __future__ import annotations

import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs as tconfigs


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_arch_config_equals_the_reference(arch, smoke):
    ref = jconfigs.get_config(arch, smoke=smoke)
    port = tconfigs.get_config(arch, smoke=smoke)
    assert isinstance(port, tconfigs.ArchConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.ffn_param_fraction() == ref.ffn_param_fraction()


def test_registry_equals_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    with pytest.raises(KeyError) as ref:
        jconfigs.get_config("opt-tiny")
    with pytest.raises(KeyError) as port:
        tconfigs.get_config("opt-tiny")
    assert str(port.value) == str(ref.value)
