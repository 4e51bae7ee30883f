"""Algorithm 2 (KV-cache-aware offload) as the configuration states it: a
bitmap of ``h`` column groups, all on the NPU at start; at each step the
NPU attention cycles at the step's KV length, ``floor(2 * kv_len * KV *
Dh / 512)``, are compared with those at the last rebalance, and an
increase ``dC`` above ``C_th = (P // u) * C_NPU`` moves ``ceil(dC /
C_th)`` more groups, the highest on the NPU first, to the flash tier.
Groups never come back. Returns the groups on the NPU after each step."""
from __future__ import annotations


def groups_on(kv_lens, model: dict) -> list[int]:
    a2 = model["alg2"]
    c_th = max((a2["page_buffer_bytes"] // a2["column_bytes"])
               * a2["c_npu_per_column"], 1)
    on, prev, out = model["alg2_groups"], 0, []
    for kv in kv_lens:
        cycles = (2 * kv * model["n_kv_heads"] * model["head_dim"]) // 512
        delta = max(cycles - prev, 0)
        k = 0 if delta <= c_th else -(-delta // c_th)
        if k and on:
            on = max(on - k, 0)
            prev = cycles
        out.append(on)
    return out
