"""Learning-rate schedules, the reference's ``optim/schedules.py`` in float64
on the host (the step is a Python number)."""

from __future__ import annotations

import math

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step, base_lr: float, total_steps: int, min_frac: float = 0.1) -> float:
    t = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * t)))


def linear_warmup_cosine(step, base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1) -> float:
    if step < warmup:
        return base_lr * min(step / max(warmup, 1), 1.0)
    return cosine_schedule(max(step - warmup, 0), base_lr, max(total_steps - warmup, 1), min_frac)
