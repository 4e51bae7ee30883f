"""Token samplers (greedy / temperature / top-k / top-p) — the port of
``repro/serving/sampler.py``.

Logits may carry any leading batch shape ``(..., V)``. ``sample`` takes a
``torch.Generator`` in place of a JAX key; greedy (temperature == 0) never
touches it, and no sampler reads a tensor on the host, so a captured step
(``repro_torch.graphs``) samples inside its graph. Torch and JAX draw
different numbers from the same seed, so only greedy sampling is
comparable token for token.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> off
    top_p: float = 1.0             # 1 -> off


def last_valid_hidden(x: torch.Tensor, q_lens: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) chunk hidden states; q_lens: (B,) valid lanes per slot.
    Returns (B, D): each slot's hidden state at its LAST valid lane (idle
    slots, q_lens == 0, clamp to lane 0; the control plane drops them)."""
    idx = torch.clamp_min(q_lens.long() - 1, 0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def filter_logits(logits: torch.Tensor, cfg: SampleConfig) -> torch.Tensor:
    """Temperature-scale and top-k/top-p mask logits (..., V). Call only
    with temperature > 0."""
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # all of V when the f32 sum never reaches top_p: keep everything,
        # as the reference's out-of-range take does
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx[..., None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SampleConfig) -> torch.Tensor:
    """logits (..., V) -> (...) int32."""
    if cfg.temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    # torch.multinomial's one-sample draw, argmax(p / q) with q ~ Exp(1),
    # written out: the same numbers from the same generator, without its
    # host-side checks of p (device reads a captured step cannot make)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)
