"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro/optim/schedule.py``.  ``step`` is an int tensor (the
optimizer's step, on its device); the result is a 0-d float32 tensor on
the same device, computed in float32 as the reference's jnp arithmetic
is, so the schedule never reads the step on the host.
"""
from __future__ import annotations

import math

import torch


def linear_warmup(step, *, peak_lr: float, warmup_steps: int):
    step = torch.as_tensor(step)
    frac = (step + 1).float() / max(1, warmup_steps)
    return peak_lr * torch.clamp(frac, max=1.0)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * peak_lr``."""
    step = torch.as_tensor(step)
    warm = linear_warmup(step, peak_lr=peak_lr, warmup_steps=warmup_steps)
    t = torch.clamp((step - warmup_steps).float()
                    / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
