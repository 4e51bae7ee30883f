"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
Backbone only; the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings (anyres tiling noted, not built)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    frontend="patch", n_patch_tokens=576,
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    frontend="patch", n_patch_tokens=8, max_seq=256,
)
