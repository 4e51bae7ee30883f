"""KV-cache-aware scheduling (paper Algorithm 2, contribution C4) and
token-budget admission — the port of the slice's part of
``repro/core/scheduler.py``.

During decode, attention runs on the NPU and FFN in flash. As the KV cache
grows, NPU attention latency grows, unbalancing the shared Q/K/V/O
projection path. Algorithm 2 monitors the per-step NPU cycle increment dC
and, when it exceeds a threshold C_th derived from the page-buffer
capacity, offloads k = ceil(dC / C_th) projection column-groups from the
NPU to the in-flash ERDPE by clearing the k highest-indexed set bits of a
dispatch bitmap B in {0,1}^H (1 = column-group on NPU).

The bitmap functions work on tensors on any device (the engine keeps the
bitmap beside the KV pool); the admission planner is host Python. Both are
held bit-exact against the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    page_buffer_bytes: int = 16 * 1024   # P: per plane-cluster page buffer
    column_bytes: int = 4096             # u: one weight column (d_model int8)
    c_npu_per_column: int = 64           # C_NPU: NPU cycles per projected column
    h: int = 32                          # H: number of dispatchable column groups

    @property
    def c_th(self) -> int:               # Alg. 2 line 1
        return (self.page_buffer_bytes // self.column_bytes) * self.c_npu_per_column


def init_bitmap(cfg: SchedulerConfig, device="cpu") -> torch.Tensor:
    """All column-groups start on the NPU (early decode, small KV cache)."""
    return torch.ones((cfg.h,), dtype=torch.int32, device=device)


def kv_aware_update(bitmap: torch.Tensor, delta_c: torch.Tensor,
                    cfg: SchedulerConfig) -> torch.Tensor:
    """One Algorithm 2 step: returns B^(n+1) given B^(n) and cycle increment."""
    c_th = max(cfg.c_th, 1)
    delta_c = torch.as_tensor(delta_c, dtype=torch.int32, device=bitmap.device)
    k = torch.where(delta_c <= c_th, 0, -(-delta_c // c_th))  # ceil div
    # Clear the k highest-indexed set bits: rank of each set bit counted
    # from the top; clear where rank <= k.
    ones = bitmap > 0
    rank_from_top = ones.flip(0).int().cumsum(0).flip(0)
    clear = ones & (rank_from_top <= k)
    return torch.where(clear, 0, bitmap).to(torch.int32)


def estimate_attention_cycles(kv_len, d_model: int, n_kv_heads: int,
                              head_dim: int, npu_macs_per_cycle: int = 512
                              ) -> torch.Tensor:
    """NPU cycles for one decode step's attention aggregation at ``kv_len``
    (QK^T + AV ~ 2 * kv_len * n_kv_heads * head_dim MACs, f32 as in the
    reference)."""
    macs = 2.0 * torch.as_tensor(kv_len, dtype=torch.float32) \
        * n_kv_heads * head_dim
    return torch.div(macs, npu_macs_per_cycle,
                     rounding_mode="floor").to(torch.int32)


def kv_aware_step(bitmap: torch.Tensor, prev_cycles: torch.Tensor,
                  kv_len: torch.Tensor, d_model: int, n_kv_heads: int,
                  head_dim: int, cfg: SchedulerConfig, kv_aware: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full Algorithm 2 step at decode length ``kv_len``: estimate this
    step's NPU attention cycles, take dC against the cycles at the LAST
    rebalance, update the bitmap, and move the baseline only when the
    bitmap moved. Returns (new_bitmap, new_prev_cycles, delta_cycles)."""
    cycles = estimate_attention_cycles(kv_len, d_model, n_kv_heads,
                                       head_dim).to(bitmap.device)
    prev = torch.as_tensor(prev_cycles, dtype=torch.int32,
                           device=bitmap.device)
    delta = torch.clamp_min(cycles - prev, 0)
    if not kv_aware:
        return bitmap, cycles, delta
    new_bitmap = kv_aware_update(bitmap, delta, cfg)
    rebalanced = new_bitmap.sum() != bitmap.sum()
    new_prev = torch.where(rebalanced, cycles, prev)
    return new_bitmap, new_prev, delta


def npu_fraction(bitmap: torch.Tensor) -> torch.Tensor:
    return (bitmap > 0).float().mean()


# --- token-budget admission (mixed prefill/decode batching) -------------------


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    chunk_tokens: int = 16     # T_chunk: static chunk lanes per slot per step
    token_budget: int = 32     # per-step token budget at npu_fraction = 1.0
    budget_floor: float = 0.25 # budget fraction kept at npu_fraction = 0.0
    adaptive: bool = True      # couple the budget to Alg. 2 + streamer stall


def step_token_budget(cfg: AdmissionConfig, npu_frac: float,
                      stall_frac: float = 0.0) -> int:
    """Per-step token budget, contracted by Algorithm 2's offload state and
    by the weight streamer's stall fraction (0 on the resident path).
    Always >= 1."""
    if not cfg.adaptive:
        return max(1, cfg.token_budget)
    lo, span = cfg.budget_floor, 1.0 - cfg.budget_floor
    f = min(max(float(npu_frac), 0.0), 1.0)
    s = min(max(float(stall_frac), 0.0), 1.0)
    scale = (lo + span * f) * (lo + span * (1.0 - s))
    return max(1, int(round(cfg.token_budget * scale)))


def plan_chunks(decode_slots: list, prefill_slots: list[tuple[int, int]],
                budget: int, chunk_tokens: int, cancelled=None
                ) -> dict[int, int]:
    """Pure host-side step plan: slot -> token lanes this step.

    ``cancelled`` slots are excluded up front. Decode slots are funded
    first — one base lane each unconditionally, then any extra lanes an
    entry ``(slot, want_lanes)`` asks for, clamped to the remaining budget.
    Leftover budget funds prefill chunks in the order given (arrival
    order, so admission stays FCFS), each capped at the chunk width.
    """
    if cancelled:
        decode_slots = [s for s in decode_slots
                        if (s if isinstance(s, int) else s[0])
                        not in cancelled]
        prefill_slots = [(s, r) for s, r in prefill_slots
                         if s not in cancelled]
    wants = [(s, 1) if isinstance(s, int) else (s[0], max(1, int(s[1])))
             for s in decode_slots]
    plan = {s: 1 for s, _ in wants}
    left = budget - len(wants)
    for slot, want in wants:                 # extra lanes, budget-clamped
        extra = min(want - 1, max(left, 0))
        plan[slot] += extra
        left -= extra
    for slot, remaining in prefill_slots:
        if left <= 0:
            break
        n = min(chunk_tokens, remaining, left)
        if n > 0:
            plan[slot] = n
            left -= n
    return plan


def routed_experts(idx, q_lens):
    """The host half of the MoE expert-id bitmap handoff.

    The streamed MoE engine runs the router ON DEVICE and ships the top-k
    expert ids to the host streamer — the MoE analog of Algorithm 2's plane
    bitmap dispatch. This extracts the distinct experts actually routed by
    VALID lanes (padding lanes route garbage hidden states; fetching their
    experts would be pure wasted NAND traffic).

    idx    : (slots, T, k) host int array — this layer's top-k expert ids.
    q_lens : (slots,) host int array — valid lanes per slot this step.
    Returns a sorted numpy int array of distinct expert ids (possibly
    empty when no slot has work).
    """
    idx = np.asarray(idx)
    lanes = np.arange(idx.shape[1])[None, :, None]
    valid = np.broadcast_to(
        lanes < np.asarray(q_lens)[:, None, None], idx.shape)
    return np.unique(idx[valid])


def routed_experts_by_slot(idx, q_lens):
    """Per-slot split of ``routed_experts`` — same bitmap handoff, kept
    separated by decode slot so the expert cache's per-slot router
    histories see each sequence's routing phase instead of the batch
    union. Returns {slot: sorted distinct expert ids} covering only slots
    with valid lanes this step.
    """
    idx = np.asarray(idx)
    q_lens = np.asarray(q_lens)
    out = {}
    for s in range(idx.shape[0]):
        n = int(q_lens[s])
        if n > 0:
            out[s] = np.unique(idx[s, :n])
    return out


def split_projection(x: torch.Tensor, w_dram: torch.Tensor,
                     flash_out: torch.Tensor, bitmap: torch.Tensor
                     ) -> torch.Tensor:
    """Bitmap-dispatched projection: column-groups with bit 1 take the
    DRAM-resident weights (NPU path, an f32 GEMM; the resident engine keeps
    them in f32, made once from bf16, so ``.float()`` returns them as they
    are); groups with bit 0 take the flash-tier ERDPE result. x: (..., K);
    w_dram (K, N); flash_out (..., N); bitmap (H,) with N % H == 0.
    Returns f32."""
    n = w_dram.shape[-1]
    h = bitmap.shape[0]
    if n % h:
        raise ValueError(f"N={n} not divisible by H={h}")
    npu_out = x.float() @ w_dram.float()
    group_mask = (bitmap > 0)[:, None].expand(h, n // h).reshape(n)
    return torch.where(group_mask, npu_out, flash_out.float())
