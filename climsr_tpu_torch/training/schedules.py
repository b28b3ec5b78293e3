# -*- coding: utf-8 -*-
"""Learning-rate and momentum schedules: the port of ``climsr_tpu.training.schedules``.

Each schedule is a plain function of the update count (0 for the first
update) returning a float, with the JAX package's formulas (reference
``conf/schedulers/*.yaml``, the HuggingFace schedule family and torch
``OneCycleLR``). The optimizer (``training/optimizers.py``) reads the lr, and
beta1 or the momentum under one-cycle, from them before every update, as
``optax.scale_by_learning_rate`` and ``optax.inject_hyperparams`` do.

``resolve_schedule`` applies the reference's warmup semantics: a float
``num_warmup_steps`` < 1 is a fraction of ``num_training_steps``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

from climsr_tpu_torch.config.schemas import SchedulerConfig

Schedule = Callable[[int], float]


def _clip(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def constant_schedule_with_warmup(lr: float, num_warmup_steps: int) -> Schedule:
    def schedule(step):
        return lr * min(1.0, (step + 1) / max(1, num_warmup_steps))

    return schedule


def linear_schedule_with_warmup(lr: float, num_warmup_steps: int, num_training_steps: int) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return lr * (step + 1) / max(1, num_warmup_steps)
        return lr * max(0.0, (num_training_steps - step) / max(1, num_training_steps - num_warmup_steps))

    return schedule


def _progress(step: int, num_warmup_steps: int, num_training_steps: int) -> float:
    return _clip((step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps), 0.0, 1.0)


def cosine_schedule_with_warmup(
    lr: float, num_warmup_steps: int, num_training_steps: int, num_cycles: float = 0.5
) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return lr * (step + 1) / max(1, num_warmup_steps)
        progress = _progress(step, num_warmup_steps, num_training_steps)
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress)))

    return schedule


def cosine_with_hard_restarts_schedule_with_warmup(
    lr: float, num_warmup_steps: int, num_training_steps: int, num_cycles: float = 1.0
) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return lr * (step + 1) / max(1, num_warmup_steps)
        progress = _progress(step, num_warmup_steps, num_training_steps)
        if progress >= 1.0:
            return 0.0
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((progress * num_cycles) % 1.0))))

    return schedule


def polynomial_decay_schedule_with_warmup(
    lr: float, num_warmup_steps: int, num_training_steps: int, power: float = 1.0, lr_end: float = 1e-7
) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return lr * (step + 1) / max(1, num_warmup_steps)
        if step > num_training_steps:
            return lr_end
        remaining = _clip((num_training_steps - step) / max(1, num_training_steps - num_warmup_steps), 0.0, 1.0)
        return (lr - lr_end) * remaining**power + lr_end

    return schedule


def _one_cycle_phases(num_training_steps: int, pct_start: float):
    up_steps = max(1, int(math.ceil(pct_start * num_training_steps)) - 1)
    down_steps = max(1, num_training_steps - up_steps - 1)
    return up_steps, down_steps


def one_cycle_schedule(
    max_lr: float,
    num_training_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 2.0,
    final_div_factor: float = 100.0,
) -> Schedule:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps, down_steps = _one_cycle_phases(num_training_steps, pct_start)

    def schedule(step):
        if step <= up_steps:
            return initial_lr + (max_lr - initial_lr) * 0.5 * (1.0 - math.cos(math.pi * min(step, up_steps) / up_steps))
        pos = _clip((step - up_steps) / down_steps, 0.0, 1.0)
        return min_lr + (max_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * pos))

    return schedule


def one_cycle_momentum_schedule(
    num_training_steps: int,
    pct_start: float = 0.05,
    base_momentum: float = 0.85,
    max_momentum: float = 0.95,
) -> Schedule:
    """torch OneCycleLR's momentum co-cycle (``cycle_momentum=True``): momentum
    (Adam's beta1) anneals inversely to the lr over the same phases."""
    up_steps, down_steps = _one_cycle_phases(num_training_steps, pct_start)

    def schedule(step):
        if step <= up_steps:
            return max_momentum + (base_momentum - max_momentum) * 0.5 * (
                1.0 - math.cos(math.pi * min(step, up_steps) / up_steps)
            )
        pos = _clip((step - up_steps) / down_steps, 0.0, 1.0)
        return max_momentum + (base_momentum - max_momentum) * 0.5 * (1.0 + math.cos(math.pi * pos))

    return schedule


SCHEDULES = {
    "constant_schedule": constant_schedule,
    "constant_schedule_with_warmup": constant_schedule_with_warmup,
    "linear_schedule_with_warmup": linear_schedule_with_warmup,
    "cosine_schedule_with_warmup": cosine_schedule_with_warmup,
    "cosine_with_hard_restarts_schedule_with_warmup": cosine_with_hard_restarts_schedule_with_warmup,
    "polynomial_decay_schedule_with_warmup": polynomial_decay_schedule_with_warmup,
    "one_cycle_schedule": one_cycle_schedule,
}


def compute_warmup(num_training_steps: int, num_warmup_steps: Optional[float]) -> int:
    """Float < 1.0 means a fraction of training steps (reference task.py:85-92)."""
    if num_warmup_steps is None:
        return 0
    if isinstance(num_warmup_steps, float) and num_warmup_steps < 1.0:
        return int(num_warmup_steps * num_training_steps)
    return int(num_warmup_steps)


def _total_steps(cfg: SchedulerConfig, num_training_steps: int) -> int:
    return cfg.num_training_steps if cfg.num_training_steps and cfg.num_training_steps > 0 else num_training_steps


def resolve_schedule(cfg: Optional[SchedulerConfig], base_lr: float, num_training_steps: int) -> Schedule:
    """Build the schedule named by ``cfg`` with inferred total/warmup steps."""
    if cfg is None:
        return constant_schedule(base_lr)
    name = cfg.name
    if name not in SCHEDULES:
        raise KeyError(f"Unknown scheduler '{name}'. Available: {sorted(SCHEDULES)}")
    total = _total_steps(cfg, num_training_steps)
    warmup = compute_warmup(total, cfg.num_warmup_steps)
    if name == "constant_schedule":
        return constant_schedule(base_lr)
    if name == "constant_schedule_with_warmup":
        return constant_schedule_with_warmup(base_lr, warmup)
    if name == "one_cycle_schedule":
        return one_cycle_schedule(
            max_lr=cfg.max_lr or base_lr,
            num_training_steps=total,
            pct_start=cfg.pct_start,
            div_factor=cfg.div_factor,
            final_div_factor=cfg.final_div_factor,
        )
    if name == "cosine_schedule_with_warmup":
        return cosine_schedule_with_warmup(base_lr, warmup, total, cfg.num_cycles)
    if name == "cosine_with_hard_restarts_schedule_with_warmup":
        return cosine_with_hard_restarts_schedule_with_warmup(base_lr, warmup, total, cfg.num_cycles)
    if name == "polynomial_decay_schedule_with_warmup":
        return polynomial_decay_schedule_with_warmup(base_lr, warmup, total, cfg.power, cfg.lr_end)
    return linear_schedule_with_warmup(base_lr, warmup, total)


def resolve_momentum_schedule(cfg: Optional[SchedulerConfig], num_training_steps: int) -> Optional[Schedule]:
    """Momentum (Adam beta1) co-schedule, or None when the lr schedule has none
    (only one-cycle with ``cycle_momentum`` cycles it)."""
    if cfg is None or cfg.name != "one_cycle_schedule" or not cfg.cycle_momentum:
        return None
    return one_cycle_momentum_schedule(
        num_training_steps=_total_steps(cfg, num_training_steps),
        pct_start=cfg.pct_start,
        base_momentum=cfg.base_momentum,
        max_momentum=cfg.max_momentum,
    )
