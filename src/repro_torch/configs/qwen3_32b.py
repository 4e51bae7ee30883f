"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]. Qwen3 uses decoupled head_dim=128."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_base=1e6,
)

SMOKE = ArchConfig(
    name="qwen3-32b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    qk_norm=True, max_seq=256,
)
