"""One ``ArchConfig`` for every model family, with its analytical parameter
counts — a copy of ``repro/configs/base.py``. The port imports nothing of
the JAX package (its ``configs/__init__`` loads jax), so the dataclass is
kept here field for field and the tests hold the two equal.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | rglru | rwkv6 | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm_type: str = "rms"            # rms | layer
    ffn_type: str = "swiglu"          # swiglu | gelu
    qk_norm: bool = False
    use_rope: bool = True
    rope_base: float = 10000.0
    local_window: int | None = None
    max_seq: int = 131072
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_expert_groups: int = 1
    topk_expert_groups: int = 0
    # rglru
    lru_width: int | None = None
    conv_width: int = 4
    # rwkv6
    rwkv_head_dim: int = 64
    # encdec
    n_enc_layers: int = 0
    # modality frontend stubs
    frontend: str | None = None       # None | "patch" (vlm) | "frames" (audio)
    n_patch_tokens: int = 0
    # capability flags
    sub_quadratic: bool = False
    remat_groups: int = 0

    # --- analytical parameter counts (weights only, no ECC overhead) -------

    def _attn_params(self) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * dh + 2 * d * kv * dh + h * dh * d

    def _ffn_params(self) -> int:
        mult = 3 if self.ffn_type == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _layer_params(self) -> int:
        d = self.d_model
        if self.family == "dense":
            return self._attn_params() + self._ffn_params() + 2 * d
        if self.family == "moe":
            expert = 3 * d * self.d_ff
            return (self._attn_params() + d * self.n_experts
                    + self.n_experts * expert + 2 * d)
        if self.family == "rglru":
            r = self.lru_width or d
            rec = 2 * d * r + r * d + self.conv_width * r + 7 * r
            rec_layer = rec + self._ffn_params() + 2 * d
            attn_layer = self._attn_params() + self._ffn_params() + 2 * d
            n_attn = self.n_layers // 3
            return ((rec_layer * (self.n_layers - n_attn)
                     + attn_layer * n_attn) // self.n_layers)
        if self.family == "rwkv6":
            tmix = 5 * d * d + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d + 8 * d
            cmix = d * self.d_ff + self.d_ff * d + d * d
            return tmix + cmix + 2 * d
        if self.family == "encdec":
            enc = (self._attn_params() + 2 * d * self.d_ff + 2 * d)
            dec = (2 * self._attn_params() + 2 * d * self.d_ff + 3 * d)
            total = enc * self.n_enc_layers + dec * self.n_layers
            return total // max(self.n_layers, 1)
        raise ValueError(self.family)

    def param_count(self) -> int:
        """Total parameters (embeddings + stacked layers + LM head)."""
        body = self._layer_params() * self.n_layers
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return body + embed + head

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        expert = 3 * d * self.d_ff
        per_layer_active = (self._attn_params() + d * self.n_experts
                            + self.top_k * expert + 2 * d)
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return per_layer_active * self.n_layers + embed + head

    def ffn_param_fraction(self) -> float:
        """Fraction of params in the flash tier (FFN + LM head)."""
        if self.family == "moe":
            ffn = self.n_experts * 3 * self.d_model * self.d_ff * self.n_layers
        elif self.family == "rwkv6":
            d = self.d_model
            ffn = (d * self.d_ff + self.d_ff * d + 5 * d * d + d * d) * self.n_layers
        elif self.family == "rglru":
            r = self.lru_width or self.d_model
            n_attn = self.n_layers // 3
            ffn = (self._ffn_params() * self.n_layers
                   + (2 * self.d_model * r + r * self.d_model)
                   * (self.n_layers - n_attn))
        elif self.family == "encdec":
            ffn = 2 * self.d_model * self.d_ff * (self.n_layers + self.n_enc_layers)
        else:
            ffn = self._ffn_params() * self.n_layers
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return (ffn + head) / self.param_count()

