"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
— llama-arch, code [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=49152,
)

SMOKE = ArchConfig(
    name="granite-8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, max_seq=256,
)
