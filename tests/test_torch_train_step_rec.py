"""``launch.steps.make_train_step`` for RWKV-6 and the RG-LRU hybrid
against the reference's step run op by op, at n_micro 1 and 2
(tests/torch_train_parity.py holds the check and its bounds)."""
from __future__ import annotations

import pytest

import torch_train_parity as tp_


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_train_step_matches_reference(arch, n_micro):
    tp_.check_train_step(arch, n_micro)
