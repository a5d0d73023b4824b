"""Learning-rate schedules (pure functions of the step), the port of
``repro/optim/schedule.py``: fp32 0-dim tensors, on the step's device."""

from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    return peak * ((s + 1) / max(warmup_steps, 1)).clamp_max(1.0)


def cosine_schedule(
    step,
    peak: float,
    warmup_steps: int,
    total_steps: int,
    floor: float = 0.1,
) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = ((s + 1) / max(warmup_steps, 1)).clamp_max(1.0)
    frac = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak * warm * cos
