"""LR schedules as step -> lr functions — the port of
``repro/optim/schedule.py``. ``step`` is a Python int or a 0-d tensor
(the optimizer's int32 step); the lr is a 0-d f32 tensor on the step's
device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr
