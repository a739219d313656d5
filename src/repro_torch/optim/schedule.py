"""Learning-rate schedules (port of ``repro/optim/schedule.py``): f32
scalars on the step's device, so a train step reads its rate without a
host round trip."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 over ``warmup_steps``, then a cosine from
    ``peak_lr`` down to ``min_ratio * peak_lr`` at ``total_steps`` (held
    after).  Step 0 gives 0: the first step of a run moves no parameter."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.tensor(peak_lr, dtype=torch.float32,
                        device=step.device if isinstance(step, torch.Tensor) else None)
