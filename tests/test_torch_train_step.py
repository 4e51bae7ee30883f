"""``launch.steps.make_train_step`` / ``make_eval_step`` against the JAX
package's: one step at n_micro 1 and 2 per family against the reference's
step run op by op (tests/torch_train_parity.py holds the check and its
bounds; the recurrent families: tests/test_torch_train_step_rec.py), the
reference's grad-accumulation scenario (tests/test_integration.py:27) on
the port, and the accumulator's dtype.
"""
from __future__ import annotations

import pytest
import torch

import torch_train_parity as tp_
from repro_torch.launch.steps import make_eval_step, make_train_step
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-medium"])
def test_train_step_matches_reference(arch, n_micro):
    tp_.check_train_step(arch, n_micro)


def test_grad_accumulation_equivalence():
    """n_micro=4 must equal n_micro=1 on the same global batch (the
    reference's bounds: loss within 5e-2, every param within 5e-2)."""
    _, cfg, _, params = tp_.setup("granite-8b")
    tb = tp_.both(tp_.batch(cfg, 8, 16, seed=4))[1]
    opt = AdamW(lr=1e-2)
    p1, _, m1 = make_train_step(cfg, opt, n_micro=1)(
        tp_.clone_tree(params), opt.init(params), tb)
    p4, _, m4 = make_train_step(cfg, opt, n_micro=4)(
        tp_.clone_tree(params), opt.init(params), tb)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 5e-2
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(p1), tree_leaves(p4))]
    assert max(diffs) < 5e-2


@pytest.mark.parametrize("accum", [torch.float32, torch.bfloat16])
def test_accumulator_dtype_and_eval_step(accum):
    """The microbatch gradients sum in ``accum_dtype`` zeros (the first
    moments after one step are 0.1 x their mean, clipped); ``.grad`` is
    never set; the eval step's loss is the train step's before it."""
    _, cfg, _, params = tp_.setup("granite-8b")
    tb = tp_.both(tp_.batch(cfg, 4, 16, seed=5))[1]
    before = float(make_eval_step(cfg)(params, tb))
    opt = AdamW(lr=1e-3, clip_norm=None)
    p, st, m = make_train_step(cfg, opt, n_micro=2, accum_dtype=accum)(
        tp_.clone_tree(params), opt.init(params), tb)
    assert abs(float(m["loss"]) - before) <= 1e-5
    assert all(x.grad is None for x in tree_leaves(p))
    f32 = make_train_step(cfg, opt, n_micro=2)(
        tp_.clone_tree(params), opt.init(params), tb)[1]
    for a, b in zip(tree_leaves(st.m), tree_leaves(f32.m)):
        if accum == torch.float32:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= \
                float(b.abs().max()) * 2.0 ** -6
