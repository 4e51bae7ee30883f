"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA 128k vocab [arXiv:2407.21783; unverified].
The capacity-stress case: see EXPERIMENTS.md §Dry-run HBM-fit notes."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248, vocab_size=128256,
    rope_base=5e5, max_seq=131072, remat_groups=14,   # sqrt-remat: 14x9 layers
)

SMOKE = ArchConfig(
    name="llama3-405b-smoke", family="dense", n_layers=3, d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=8, d_ff=256, vocab_size=512, max_seq=256,
)
