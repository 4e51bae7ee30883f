"""The paper's own evaluation models (§4.1): OPT-1.3B..30B and LLaMA2-7B,
plus the tiny runnable OPT the tests serve — a copy of
``repro/configs/paper_models.py``.

OPT: LayerNorm + GELU FFN + learned positions (use_rope=False).
"""
from repro_torch.configs.base import ArchConfig


def _opt(name, n_layers, d_model, n_heads, d_ff):
    return ArchConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab_size=50272, norm_type="layer", ffn_type="gelu",
        use_rope=False, max_seq=2048,
    )


OPT_1_3B = _opt("opt-1.3b", 24, 2048, 32, 8192)
OPT_2_7B = _opt("opt-2.7b", 32, 2560, 32, 10240)
OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32, 16384)
OPT_13B = _opt("opt-13b", 40, 5120, 40, 20480)
OPT_30B = _opt("opt-30b", 48, 7168, 56, 28672)

LLAMA2_7B = ArchConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=32000,
    max_seq=4096,
)

OPT_FAMILY = [OPT_1_3B, OPT_2_7B, OPT_6_7B, OPT_13B, OPT_30B]

# Tiny runnable OPT for the engine tests.
OPT_TINY = ArchConfig(
    name="opt-tiny", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512, norm_type="layer",
    ffn_type="gelu", use_rope=False, max_seq=512,
)
