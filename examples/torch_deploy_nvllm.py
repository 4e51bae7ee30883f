"""Deployment example on the PyTorch port: train briefly, checkpoint,
convert to the tiered NVLLM flash format with RBER injection, verify the
deployed model still serves — the full lifecycle of an edge deployment
(the same steps as ``examples/deploy_nvllm.py``, through ``repro_torch``).

    PYTHONPATH=src python examples/torch_deploy_nvllm.py [--device cpu]

It runs on the card (the engines' steps captured in a CUDA graph, the
flash tier read by the ECDP kernel) unless ``--device cpu``.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.paper_models import OPT_TINY
from repro_torch.launch.steps import make_train_step
from repro_torch.models import dense
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    gen = torch.Generator(device=device).manual_seed(0)
    params = dense.init(OPT_TINY, gen, device=device)
    opt = AdamW(lr=3e-3)
    state = opt.init(params)
    step = make_train_step(OPT_TINY, opt)
    for _ in range(10):
        toks = torch.randint(0, OPT_TINY.vocab_size, (4, 32), generator=gen,
                             device=device)
        # the step updates params and moments in place
        params, state, m = step(params, state,
                                {"tokens": toks, "labels": toks})
    print(f"trained 10 steps, loss {float(m['loss']):.3f}")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d + "/ckpt")
        mgr.save(10, params, {"step": 10})
        restored, _ = mgr.restore(params, device=device)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(restored), tree_leaves(params)))
        print("checkpoint round-trip OK")

        # flash-programming step: INT8 + Hamming(72,64), RBER injected
        eng = Engine(OPT_TINY, restored, max_slots=1, max_seq=64, rber=1e-4,
                     device=device)
        rid = eng.submit([1, 2, 3, 4], max_new=8)
        out = eng.run()[rid]
        print(f"deployed engine (RBER=1e-4, ECC on) decoded: {out}")

        clean = Engine(OPT_TINY, restored, max_slots=1, max_seq=64,
                       rber=0.0, device=device)
        # NB: subscripting run() with an inline submit() evaluates run()
        # FIRST (empty engine) — submit must happen before run.
        rid_clean = clean.submit([1, 2, 3, 4], max_new=8)
        out_clean = clean.run()[rid_clean]
        assert out == out_clean, "ECC must make RBER invisible"
        print("deploy_nvllm OK — corrupted flash reads decode identically")


if __name__ == "__main__":
    main()
