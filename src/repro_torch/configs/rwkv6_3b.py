"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf].
Attention-free: O(1) state -> runs long_500k; NVLLM Alg. 2 (KV-cache-aware
rebalancing) is inapplicable (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="rwkv6", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64, sub_quadratic=True, max_seq=1048576,
)

SMOKE = ArchConfig(
    name="rwkv6-3b-smoke", family="rwkv6", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    rwkv_head_dim=16, sub_quadratic=True, max_seq=256,
)
