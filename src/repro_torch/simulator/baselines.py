"""Baseline systems for the paper's comparisons (Table 1) — the port of
``repro/simulator/baselines.py``, the same arithmetic over the port's
``ArchConfig``; nothing of the reference module is left out.

GPU-centric (A800 + FlexGen out-of-core): decode is weight-streaming-bound
over the offload link at an *effective* bandwidth (storage access
granularity, §1) plus a fixed per-token host-orchestration overhead; both
were calibrated on the two endpoints of Fig. 6(a) — every other model size
is a prediction. Prefill runs from HBM at GPU compute rates (GPUs are
compute-rich: prefill is fast, decode is the bottleneck — Fig. 7).

SSD-like in-flash (Cambricon-LLM / AiF / AiF--): decode streams all weights
through the flash channels at each design's published effective internal
bandwidth; anchors are their published LLaMA2-7B numbers (3.6 / 13.1 /
9.8 tokens/s).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.simulator import hw
from repro_torch.simulator.system import _weights


@dataclasses.dataclass(frozen=True)
class StreamingBaseline:
    name: str
    eff_bw: float
    token_overhead_s: float
    prefill_gops: float = 100e12     # A800-class INT8 prefill throughput

    def decode_token_time(self, cfg: ArchConfig, kv_len: int = 64) -> float:
        attn_b, ffn_b, embed_b = _weights(cfg)
        weight_bytes = attn_b + ffn_b            # streamed every token
        return weight_bytes / self.eff_bw + self.token_overhead_s

    def decode_tps(self, cfg: ArchConfig, kv_len: int = 64) -> float:
        return 1.0 / self.decode_token_time(cfg, kv_len)

    def prefill_time(self, cfg: ArchConfig, n_tokens: int) -> float:
        ops = 2.0 * cfg.active_param_count() * n_tokens
        attn_b, ffn_b, _ = _weights(cfg)
        # weights still stream once over the offload link during prefill
        return max(ops / self.prefill_gops,
                   (attn_b + ffn_b) / self.eff_bw)

    def inference_time(self, cfg: ArchConfig, n_prefill: int,
                       n_decode: int) -> dict:
        t_pre = self.prefill_time(cfg, n_prefill)
        t_dec = sum(self.decode_token_time(cfg, n_prefill + i)
                    for i in range(n_decode))
        return {"prefill_s": t_pre, "decode_s": t_dec,
                "total_s": t_pre + t_dec,
                "prefill_frac": t_pre / (t_pre + t_dec)}

    def movement_energy_per_token(self, cfg: ArchConfig,
                                  kv_len: int = 64) -> float:
        attn_b, ffn_b, _ = _weights(cfg)
        kv_bytes = (2.0 * kv_len * cfg.n_kv_heads * cfg.head_dim
                    * cfg.n_layers * hw.DRAM_KV_DTYPE_BYTES)
        pj = ((attn_b + ffn_b) * (hw.E_NAND_READ + hw.E_CHAN_SSD)
              + (kv_bytes + attn_b) * hw.E_DRAM)
        return pj * 1e-12


GPU_SSD = StreamingBaseline("GPU-SSD", hw.GPU_SSD_EFF_BW,
                            hw.GPU_SSD_TOKEN_OVERHEAD_S)
GPU_DRAM = StreamingBaseline("GPU-DRAM", hw.GPU_DRAM_EFF_BW,
                             hw.GPU_DRAM_TOKEN_OVERHEAD_S)
CAMBRICON = StreamingBaseline("Cambricon-LLM", hw.CAMBRICON_EFF_BW,
                              hw.CAMBRICON_TOKEN_OVERHEAD_S)
AIF = StreamingBaseline("AiF", hw.AIF_EFF_BW, hw.AIF_TOKEN_OVERHEAD_S)
AIF_MINUS = StreamingBaseline("AiF--", hw.AIF_MINUS_EFF_BW,
                              hw.AIF_MINUS_TOKEN_OVERHEAD_S)
