"""LR schedules as step -> lr callables (the port of
``repro.optim.schedules``; the step is a Python int, the lr a float)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * progress)))
    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def fn(step):
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        return peak_lr * math.sqrt(warmup_steps / max(step, warmup_steps))
    return fn
