"""Learning-rate schedules (functions of the integer step)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = min(float(step), total_steps) / total_steps
        cos = 0.5 * (1 + math.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    body = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        if step < warmup:
            return lr * step / max(warmup, 1)
        return body(step - warmup)
    return f
