"""RWKV-6's and the RG-LRU hybrid's ``train_loss`` and gradients against
the JAX package's, op by op, at the smoke configs with the JAX init's
params (tests/torch_train_parity.py holds the checks and says why op by
op): the loss within 1e-3, each gradient leaf within 2^-4 of its largest
element. RWKV-6 through the port's ``wkv_chunked``, the RG-LRU through
``rg_lru_seq`` and its local-window attention layers (24 positions past
its smoke window of 16); and that window over 32 positions at a kv_block
of 16 keeps every gradient finite.
"""
from __future__ import annotations

import pytest

import torch_train_parity as tp_


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_train_loss_and_grads_match_reference(arch):
    tp_.check_loss_and_grads(arch)


def test_short_window_gradients_are_finite():
    tp_.check_short_window("recurrentgemma-9b", 16, 32)
