"""Learning-rate schedules as functions of the optimizer step, as
``repro/optim/schedules.py``: ``constant``, ``cosine`` (with linear
warmup) and ``wsd`` (warmup-stable-decay)."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def cosine(lr: float, total_steps: int, warmup: int = 0,
           min_ratio: float = 0.1) -> Schedule:
    def f(step: int) -> float:
        # warmup reaches lr at `warmup`, starting above zero at step 0
        warm = min((step + 1.0) / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * t))
        return lr * warm * cos
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, min_ratio: float = 0.1) -> Schedule:
    """Warmup-stable-decay: linear warmup, flat plateau, linear final
    decay to ``min_ratio·lr``."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step: int) -> float:
        warm = min((step + 1.0) / warmup, 1.0)
        t = min(max((step - decay_start)
                    / max(total_steps - decay_start, 1), 0.0), 1.0)
        return lr * warm * (1.0 - (1.0 - min_ratio) * t)
    return f
