"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
NVLLM best-fit case: 128-expert bank is ~97% of params (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab_size=151936,
    qk_norm=True, rope_base=1e6, n_experts=128, top_k=8,
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=512,
    qk_norm=True, n_experts=8, top_k=2, max_seq=256,
)
