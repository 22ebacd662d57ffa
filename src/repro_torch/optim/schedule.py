"""LR schedules: functions of a step tensor, computed on its device.

The counterpart of ``repro.optim.schedule``.  The step is a 0-d integer
tensor (the optimizer state's ``step``), so a train step reads no number
back to the host to find its learning rate.
"""

from __future__ import annotations

import math

import torch


def cosine_warmup(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; a 0-d f32 tensor on
    ``step``'s device, in ``repro``'s order of operations."""
    s = step.to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)
