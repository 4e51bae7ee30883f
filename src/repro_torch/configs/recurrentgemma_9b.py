"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2 [arXiv:2402.19427; unverified].
Sub-quadratic: local window 2048 + O(1) recurrent state -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="rglru", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    local_window=2048, lru_width=4096, conv_width=4, sub_quadratic=True,
    max_seq=1048576,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="rglru", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    local_window=16, lru_width=64, conv_width=4, sub_quadratic=True, max_seq=256,
)
