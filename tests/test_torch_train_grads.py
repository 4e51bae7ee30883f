"""The dense, MoE and encoder-decoder families' ``train_loss`` and
gradients against the JAX package's ``jax.value_and_grad(mod.train_loss)``,
run op by op (tests/torch_train_parity.py says why and holds the checks),
at the smoke configs with the JAX init's params: the loss within 1e-3, each gradient
leaf (bf16, the params' dtype) within 2^-4 of its largest element. The
port's gradients come from ``launch.steps.value_and_grad``, which hands
each stacked param to the loss as per-layer leaves. Also: the patch
frontend's positions leave the loss (llava-next-34b), and windowed
attention keeps every gradient finite when the window is shorter than the
sequence. The recurrent families': tests/test_torch_train_grads_rec.py.
"""
from __future__ import annotations

import pytest
import torch

import torch_train_parity as tp_
from repro_torch.models import family_module


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "llava-next-34b", "seamless-m4t-medium"])
def test_train_loss_and_grads_match_reference(arch):
    tp_.check_loss_and_grads(arch)


def test_patch_positions_leave_the_loss():
    """llava's patch embeddings prepend P positions; the loss is the
    token positions' alone: equal to the cross-entropy of the forward's
    logits past the first P."""
    _, cfg, _, tp = tp_.setup("llava-next-34b")
    tb = tp_.both(tp_.batch(cfg, 2, 12, n_patch=5))[1]
    mod = family_module(cfg.family)
    with torch.no_grad():
        logits = mod.forward(cfg, tp, tb["tokens"],
                             extra_embeds=tb["patch_embeds"])
        assert logits.shape[1] == 12 + 5
        want = torch.nn.functional.cross_entropy(
            logits[:, 5:].reshape(-1, cfg.vocab_size),
            tb["labels"].reshape(-1).long())
        got = mod.train_loss(cfg, tp, tb)
    assert abs(float(got) - float(want)) <= 1e-5


def test_short_window_gradients_are_finite():
    """granite given a window of 8 over 40 positions."""
    tp_.check_short_window("granite-8b", 8, 40)


def test_sqrt_remat_groups_give_the_same_gradients():
    """``cfg.remat_groups`` G dividing L (llama3-405b's 14 x 9): G groups of
    L/G layers, each group and each layer in it rematerialized. Remat
    recomputes the same ops, so the loss and every gradient equal the
    per-layer remat's bit for bit (granite-8b smoke at 4 layers, G 2)."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.optim.adamw import tree_leaves

    _, cfg, _, _ = tp_.setup("granite-8b")
    cfg = dataclasses.replace(cfg, n_layers=4)
    params = family_module(cfg.family).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    tb = tp_.both(tp_.batch(cfg, 2, 16, seed=6))[1]
    got = {}
    for g in (0, 2):
        c = dataclasses.replace(cfg, remat_groups=g)
        got[g] = steps.value_and_grad(c, params, tb)
    assert torch.equal(got[0][0], got[2][0])
    for a, b in zip(tree_leaves(got[0][1]), tree_leaves(got[2][1])):
        assert torch.equal(a, b)
