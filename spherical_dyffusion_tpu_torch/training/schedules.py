"""Learning-rate schedules as functions of the optimizer step.

Counterpart of ``spherical_dyffusion_tpu/training/schedules.py``, which
builds optax schedules: the same values, written out (optax's
``constant_schedule``, ``cosine_decay_schedule`` and
``warmup_cosine_decay_schedule`` with ``init_value`` 0, so step 0 trains at
learning rate 0). The trainer sets the value of the step it is about to
apply on every parameter group before ``optimizer.step()``.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["linear_warmup_cosine", "get_scheduler"]

Schedule = Callable[[int], float]


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * c + alpha), c =
    (1 + cos(pi * min(step, decay_steps) / decay_steps)) / 2."""

    def fn(step: int) -> float:
        frac = min(step, decay_steps) / decay_steps
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         warmup_start_lr: float = 0.0, eta_min: float = 0.0) -> Schedule:
    """Linear warmup from ``warmup_start_lr`` to ``base_lr`` over
    ``max(warmup_steps, 1)`` steps, then cosine annealing to ``eta_min`` at
    ``max(total_steps, warmup_steps + 1)``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    cos = _cosine(base_lr, decay - warmup, eta_min / base_lr if base_lr else 0.0)

    def fn(step: int) -> float:
        if step < warmup:
            return warmup_start_lr + (base_lr - warmup_start_lr) * step / warmup
        return cos(step - warmup)

    return fn


def get_scheduler(name: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
                  eta_min: float = 0.0) -> Schedule:
    name = (name or "constant").lower()
    if name in ("constant", "none"):
        return lambda step: base_lr
    if name in ("cosine", "cosine_annealing"):
        return _cosine(base_lr, max(total_steps, 1), eta_min / max(base_lr, 1e-12))
    if name in ("linear_warmup_cosine", "warmup_cosine", "linearwarmupcosineannealinglr"):
        return linear_warmup_cosine(base_lr, warmup_steps, total_steps, eta_min=eta_min)
    raise ValueError(f"Unknown scheduler {name!r}")
