"""End-to-end training driver example on the PyTorch port: a reduced
granite, a few hundred steps, with async checkpointing (the same steps as
``examples/train_tiny.py``, through ``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_train_tiny.py [--steps 200] \
        [--device cpu]

The config is a reduced granite (llama-arch) at width 256: ~17M params;
pass --d-model 512 --layers 8 for the ~100M variant. It trains on the card
unless ``--device cpu``. ``--ckpt`` defaults to a fresh temporary
directory, removed at the end (``train`` resumes from a directory's last
checkpoint, so a reused one would train nothing).
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch import train as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    base = get_config("granite-8b", smoke=True)
    cfg = dataclasses.replace(
        base, d_model=args.d_model, n_layers=args.layers,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 128,
        head_dim=64, d_ff=args.d_model * 4, vocab_size=2048)
    n_params = cfg.param_count()
    print(f"training {cfg.name} variant: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps")

    # train() resolves the arch by name: hand it this config
    orig = T.get_config
    T.get_config = lambda name, smoke=True: cfg
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = T.train("granite-8b", smoke=True, steps=args.steps,
                          batch=8, seq=64, ckpt_dir=args.ckpt or tmp,
                          ckpt_every=50, lr=3e-3, device=args.device)
    finally:
        T.get_config = orig
    l0 = sum(out["losses"][:10]) / 10
    l1 = sum(out["losses"][-10:]) / 10
    print(f"loss {l0:.3f} -> {l1:.3f} over {args.steps} steps "
          f"({out['seconds']:.0f}s)")
    assert l1 < l0, "model must learn the synthetic stream"
    print("train_tiny OK")


if __name__ == "__main__":
    main()
