"""LR schedules — counterpart of `repro/optim/schedule.py`: pure functions
of the step counter, a 0-d tensor, computed in fp32 on its device."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor_frac: float = 0.1):
    """Linear warmup → cosine decay to floor_frac·peak."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor_frac * peak_lr + (1 - floor_frac) * peak_lr * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
