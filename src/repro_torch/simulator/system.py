"""NVLLM system performance model (paper §3.5 dataflow + Algorithm 2) —
the port of ``repro/simulator/system.py`` over the port's ``ArchConfig``:
the same float arithmetic in the same order, so every number equals the
reference's bit for bit. Nothing of the reference module is left out.

Per-layer decode is SEQUENTIAL attention -> FFN (data dependency), each
phase limited by max(weight streaming, compute); prefill is compute-bound
on the combined NAND+NPU GOPS (the paper: "the prefill phase stays
compute-bound", Fig. 7 discussion).

Algorithm 2 enters when the KV-cache term pushes NPU attention latency past
C_th: Q/K/V/O column-groups move to the in-flash engine (their weights are
in NAND anyway), and the model picks the bitmap fraction f that balances
the two pipelines — the continuous relaxation of the bitmap's discrete
column groups:

    t_npu(f)  = (1-f)*qkvo/npu + kv_term
    t_nand(f) = max( (ffn_ops + f*qkvo_ops)/nand_gops,
                     (ffn_bytes + f*qkvo_bytes)/nand_bw )
    t_decode  = min_f max(t_npu, t_nand)

Weight accounting uses the ArchConfig analytical parameter counts (INT8 =
1 byte/param, §4.1) split into the flash tier (FFN + head) and DRAM tier
(Q/K/V/O) by tier fraction — the same split core/tiering.py applies to real
pytrees.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.simulator import hw


@dataclasses.dataclass(frozen=True)
class WorkloadPoint:
    kv_len: int = 64            # paper Fig. 6: 64-token context decode
    batch: int = 1              # edge: single batch


def _weights(cfg: ArchConfig):
    """(attn_bytes, ffn_bytes, embed_bytes) INT8, per token traversal."""
    n = cfg.param_count()
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    attn = cfg._attn_params() * cfg.n_layers
    if cfg.family == "encdec":
        attn += cfg._attn_params() * cfg.n_enc_layers
    ffn = n - embed - attn
    return float(attn), float(ffn), float(embed)


@dataclasses.dataclass
class NVLLMSystem:
    hwcfg: hw.NVLLMConfig = hw.NVLLM_8C
    kv_aware: bool = True
    sync_overhead: float = 0.0   # per-token fraction, set by ablations

    # --- decode ------------------------------------------------------------------

    def decode_token_time(self, cfg: ArchConfig,
                          wp: WorkloadPoint = WorkloadPoint()) -> float:
        attn_b, ffn_b, _ = _weights(cfg)
        qkvo_ops = 2.0 * attn_b
        ffn_ops = 2.0 * ffn_b
        kv_bytes = (2.0 * wp.kv_len * cfg.n_kv_heads * cfg.head_dim
                    * cfg.n_layers * hw.DRAM_KV_DTYPE_BYTES)
        kv_ops = 2.0 * wp.kv_len * cfg.n_heads * cfg.head_dim * cfg.n_layers
        kv_term = max(kv_bytes / hw.LPDDR5X_BW, kv_ops / self.hwcfg.npu_gops)

        # NPU phase: weight load from DRAM overlaps compute (prefetch), so
        # each phase is max(load, ops); the offloaded fraction f leaves.
        def npu_time(f):
            share = 1.0 - f
            return max(share * attn_b / hw.LPDDR5X_BW,
                       share * qkvo_ops / self.hwcfg.npu_gops) + kv_term

        def nand_time(f):
            return max((ffn_b + f * attn_b) / self.hwcfg.nand_bw,
                       (ffn_ops + f * qkvo_ops) / self.hwcfg.nand_gops)

        qkvo_phase = max(attn_b / hw.LPDDR5X_BW,
                         qkvo_ops / self.hwcfg.npu_gops)
        if not self.kv_aware:
            f = 0.0
        else:
            # Alg. 2 activates once the KV aggregation term is a sizeable
            # fraction of the Q/K/V/O phase it shares the NPU with (the
            # cycle-increment-vs-C_th test of the bitmap scheduler).
            if kv_term < 0.15 * qkvo_phase:
                f = 0.0
            else:
                # golden-section on max(npu, nand) over f in [0, 1]
                lo, hi = 0.0, 1.0
                for _ in range(40):
                    m1 = lo + 0.382 * (hi - lo)
                    m2 = lo + 0.618 * (hi - lo)
                    v1 = max(npu_time(m1), nand_time(m1))
                    v2 = max(npu_time(m2), nand_time(m2))
                    if v1 <= v2:
                        hi = m2
                    else:
                        lo = m1
                f = 0.5 * (lo + hi)
        # sequential attention -> FFN when on separate engines and NOT
        # rebalanced; once Alg. 2 merges the Q/K/V/O path into the flash
        # pipeline the engines run concurrently (decoupled execution, §3.5)
        if f == 0.0:
            t = npu_time(0.0) + nand_time(0.0)
        else:
            t = max(npu_time(f), nand_time(f))
        return t * (1.0 + self.sync_overhead)

    def decode_tps(self, cfg: ArchConfig,
                   wp: WorkloadPoint = WorkloadPoint()) -> float:
        return 1.0 / self.decode_token_time(cfg, wp)

    # --- prefill -------------------------------------------------------------------

    def prefill_time(self, cfg: ArchConfig, n_tokens: int) -> float:
        """Compute-bound at combined GOPS, floored by one full weight sweep."""
        ops = 2.0 * cfg.active_param_count() * n_tokens
        t_compute = ops / self.hwcfg.total_gops
        attn_b, ffn_b, _ = _weights(cfg)
        t_load = max(ffn_b / self.hwcfg.nand_bw, attn_b / hw.LPDDR5X_BW)
        return max(t_compute, t_load)

    # --- end-to-end ----------------------------------------------------------------

    def inference_time(self, cfg: ArchConfig, n_prefill: int,
                       n_decode: int) -> dict:
        t_pre = self.prefill_time(cfg, n_prefill)
        t_dec = 0.0
        for i in range(n_decode):
            wp = WorkloadPoint(kv_len=n_prefill + i)
            t_dec += self.decode_token_time(cfg, wp)
        return {"prefill_s": t_pre, "decode_s": t_dec,
                "total_s": t_pre + t_dec,
                "prefill_frac": t_pre / (t_pre + t_dec)}

    # --- energy ----------------------------------------------------------------------

    def movement_energy_per_token(self, cfg: ArchConfig,
                                  wp: WorkloadPoint = WorkloadPoint()) -> float:
        """Joules moved per decoded token (weights + KV), Fig. 8(b) model."""
        attn_b, ffn_b, _ = _weights(cfg)
        kv_bytes = (2.0 * wp.kv_len * cfg.n_kv_heads * cfg.head_dim
                    * cfg.n_layers * hw.DRAM_KV_DTYPE_BYTES)
        # FFN stays inside NAND; Q/K/V/O + KV in DRAM; IO hop is sparse
        # (layer transitions + final projection only, §4.5)
        io_bytes = cfg.n_layers * cfg.d_model * 4.0
        pj = (ffn_b * hw.E_NAND_READ + (attn_b + kv_bytes) * hw.E_DRAM
              + io_bytes * hw.E_IO_NVLLM)
        return pj * 1e-12
