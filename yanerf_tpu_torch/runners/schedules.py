"""Learning-rate schedules as functions of the step index.

Counterpart of ``yanerf_tpu/runners/schedules.py``, the same curves:
  * exponential: ``lr = max(min_lr, init_lr * rate^(step / decay_iters))``;
  * cosine: ``lr = (init_lr - min_lr) * 0.5 * (1 + cos(pi * (step /
    decay_iters) / num_iters)) + min_lr``;
  * linear warmup overrides the decayed lr while ``step <= warmup_steps``:
    ``lr = min(init_lr, warmup_lr + (init_lr - warmup_lr) * step / warmup_steps)``.
Update ``k`` (counted from 0) uses ``schedule(k)``: optax reads the count
before it increments it, and ``runners/optim.py`` sets the rate the same way.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def exponential_schedule(init_lr: float, min_lr: float, lr_decay_rate: float, lr_decay_iters: int) -> Callable:
    def sched(step: int) -> float:
        return max(min_lr, init_lr * lr_decay_rate ** (step / lr_decay_iters))

    return sched


def cosine_schedule(init_lr: float, min_lr: float, lr_decay_iters: int, num_iters: int) -> Callable:
    def sched(step: int) -> float:
        return (init_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * (step / lr_decay_iters) / num_iters)) + min_lr

    return sched


def with_warmup(base_schedule: Callable, init_lr: float, warmup_lr: float, warmup_steps: int) -> Callable:
    if warmup_steps <= 0:
        return base_schedule

    def sched(step: int) -> float:
        if step <= warmup_steps:
            return min(init_lr, warmup_lr + (init_lr - warmup_lr) * step / warmup_steps)
        return base_schedule(step)

    return sched


def create_lr_schedule(config, init_lr: Optional[float] = None) -> Callable:
    """The configured decay schedule (+warmup) of one param group; ``init_lr`` overrides ``config.init_lr``."""
    base_lr = float(init_lr if init_lr is not None else config["init_lr"])
    decay_type = config.get("lr_decay_type", "exponential")
    if decay_type == "exponential":
        base = exponential_schedule(
            base_lr, float(config["min_lr"]), float(config["lr_decay_rate"]), int(config["lr_decay_iters"])
        )
    elif decay_type == "cosine":
        base = cosine_schedule(base_lr, float(config["min_lr"]), int(config["lr_decay_iters"]), int(config["num_iters"]))
    else:
        raise ValueError(f"Unknown lr_decay_type: {decay_type}")
    warmup_steps = int(config.get("warmup_steps", 0) or 0)
    warmup_lr = float(config.get("warmup_lr", 0.0) or 0.0)
    return with_warmup(base, base_lr, warmup_lr, warmup_steps)
