"""Learning-rate schedules, step-indexed (port of ``repro.optim.schedule``),
computed in fp32 on the step's device in the reference's order of
operations."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
