"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].
Backbone only; the speech frontend is a STUB — input_specs() provides
precomputed frame embeddings. 12 encoder + 12 decoder layers."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, n_enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
    vocab_size=256206, ffn_type="gelu", frontend="frames",
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="encdec", n_layers=2,
    n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ffn_type="gelu", frontend="frames", max_seq=256,
)
