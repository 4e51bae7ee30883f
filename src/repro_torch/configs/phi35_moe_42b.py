"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-42b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=512,
    n_experts=4, top_k=2, max_seq=256,
)
