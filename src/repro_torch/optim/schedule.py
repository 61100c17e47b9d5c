"""LR schedules (pure functions of the step counter), in f32."""
from __future__ import annotations

import math

import torch

from repro_torch.utils import div_once

F32 = torch.float32


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    """min(1, (step + 1) / warmup) as an f32 scalar; a tensor step is
    computed in f32 on its device, a Python step in float64 and rounded
    once, as the reference's weakly typed arithmetic does."""
    w = max(warmup_steps, 1)
    if isinstance(step, torch.Tensor):
        s = step.to(F32)
        return torch.clamp(div_once(s + 1.0, w), max=1.0)
    return torch.tensor(min(1.0, (float(step) + 1.0) / w), dtype=F32)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup times a cosine from 1 down to ``min_ratio`` over
    [warmup, total], every operation in f32."""
    s = (step.to(F32) if isinstance(step, torch.Tensor)
         else torch.tensor(step, dtype=F32))
    warm = linear_warmup(s, warmup_steps)
    t = torch.clamp(div_once(s - warmup_steps,
                         max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
