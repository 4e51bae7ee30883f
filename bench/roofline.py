"""The yardstick's work counts and the H100's peaks, frozen with the
benchmark.

A serving step's work is worked out from the configuration's shapes and
from what the client side knows of the step: each request's lanes, the
context it already holds, whether the step emits its next token, and
Algorithm 2's share of column groups on the NPU. Nothing is read from what
the program launches or how it lays out its bytes, so a change that fuses,
splits or removes a kernel leaves these counts as they are.

Each use of a weight matrix, each request's attention and each KV write is
one call: (kernel, bytes, flops, peak). Bytes count each input byte once,
at the precision the configuration stores it: flash-tier INT8 with its
parity byte per 8 weights where ECC reads it, and an f32 scale per column;
DRAM projections f32; the KV cache bf16. Flops are 2 per multiply-add of
the model's own rows: padding lanes, and products the step computes and
throws away, are not work. The least time of a call is the larger of its
bytes over the HBM bandwidth and its flops over the peak of its math
(bf16 tensor cores for bf16 activations against INT8 or bf16 operands;
f32 without TF32 for the f32 projections). A kernel's roofline share is
the sum of its calls' least times over its measured device time.

A MoE step's distinct experts a layer are those its tokens' routes
select (``Step.experts``, one count a layer): the traced run reads them
from the reference's routes over the profiled steps' tokens. A MoE step
without its routes has no count.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


@dataclasses.dataclass
class Step:
    """One serving step as the clients saw it. ``lanes``: (context rows
    already cached, lanes this step, emits a token) per request that ran
    lanes; ``n_on``: Algorithm 2's column groups on the NPU during it."""
    lanes: list
    n_on: int
    experts: list | None = None       # distinct experts a layer (MoE)


def least_s(nbytes: float, flops: float, peak: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])


def flash_bytes(k: int, n: int, ecc: bool) -> float:
    return k * n * (1.125 if ecc else 1.0) + 4.0 * n


def matmul(kernel: str, rows: int, k: int, n: int, share: float = 1.0,
           flash: bool = True, ecc: bool = True):
    """``rows`` rows through ``share`` of a (K, N) weight's columns."""
    if flash:
        nbytes, peak = flash_bytes(k, n, ecc) * share, "bf16"
    else:
        nbytes, peak = 4.0 * k * n * share, "f32"
    return (kernel, nbytes, 2.0 * rows * k * n * share, peak)


def expert_calls(m: dict, n_tokens: int, distinct: float):
    """One layer's expert FFN: ``distinct`` experts read raw (no parity),
    ``n_tokens`` * top_k rows through each of their three matrices."""
    d, f, k = m["d_model"], m["d_ff"], m["top_k"]
    rows = n_tokens * k
    nbytes = distinct * (3 * d * f + 4.0 * (2 * f + d))
    return [("grouped_ecdp", nbytes, 2.0 * rows * 3 * d * f, "bf16")]


def attention_calls(m: dict, step: Step):
    """The paged attention over each request's cached context (its K/V
    read once, each lane's QK and PV over it), the chunk's own causal
    part, and the KV rows written."""
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = []
    for ctx, n, _ in step.lanes:
        if ctx:
            out.append(("paged_attn", ctx * 2 * kv * dh * 2.0,
                        4.0 * n * ctx * h * dh, "bf16"))
        out.append(("attention_chunk", n * 2 * kv * dh * 2.0,
                    4.0 * (n * (n + 1) / 2) * h * dh, "bf16"))
    return out


def layer_calls(m: dict, step: Step, layer: int = 0):
    """Layer ``layer``'s calls."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    n = sum(lanes for _, lanes, _ in step.lanes)
    calls = []
    on = 1.0
    if m.get("alg2_flash_copies"):
        on = step.n_on / m["alg2_groups"]
    for k, nn in ((d, h * dh), (h * dh, d)):          # Q and O, split
        if on > 0:
            calls.append(matmul("dram_gemm", n, k, nn, on, flash=False))
        if on < 1:
            calls.append(matmul("ecdp", n, k, nn, 1.0 - on))
    calls += [matmul("dram_gemm", n, d, kv * dh, flash=False)
              for _ in range(2)]                       # K and V
    calls += attention_calls(m, step)
    if m["family"] == "moe":
        if step.experts is None:
            raise ValueError("a MoE step's work needs its routes "
                             "(Step.experts)")
        calls.append(("router", d * m["n_experts"] * 2.0,
                      2.0 * n * d * m["n_experts"], "bf16"))
        calls += expert_calls(m, n, step.experts[layer])
    else:
        f = m["d_ff"]
        shapes = ([(d, f), (d, f), (f, d)] if m.get("ffn_type") == "swiglu"
                  else [(d, f), (f, d)])
        calls += [matmul("ecdp", n, k, nn) for k, nn in shapes]
    return calls


def step_calls(m: dict, step: Step):
    """Every call of one step: the layers', and lm_head over the rows that
    emit a token."""
    emit = sum(1 for _, _, e in step.lanes if e)
    if m["family"] == "moe":
        calls = [c for li in range(m["n_layers"])
                 for c in layer_calls(m, step, li)]
    else:
        calls = layer_calls(m, step) * m["n_layers"]
    if emit:
        calls.append(matmul("ecdp", emit, m["d_model"], m["vocab_size"]))
    return calls


def least_time(calls, kernel: str | None = None) -> float:
    """Seconds the calls (of ``kernel`` only, if given) need at least."""
    return sum(least_s(b, f, p) for k, b, f, p in calls
               if kernel is None or k == kernel)
