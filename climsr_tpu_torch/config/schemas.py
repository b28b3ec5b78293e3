# -*- coding: utf-8 -*-
"""Optimizer and scheduler config schemas: a copy of
``climsr_tpu/config/schemas.py:137-166``, same fields and defaults. The other
schemas come with the inference CLI and config composer (``ROADMAP.md``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    momentum: float = 0.0  # sgd/rmsprop


@dataclass
class SchedulerConfig:
    name: str = "one_cycle_schedule"
    num_training_steps: int = -1
    num_warmup_steps: float = 0.1
    # cosine / hard-restarts
    num_cycles: float = 0.5
    # one-cycle (torch OneCycleLR parity)
    max_lr: Optional[float] = None
    pct_start: float = 0.05
    div_factor: float = 2.0
    final_div_factor: float = 100.0
    # torch OneCycleLR momentum co-cycle (defaults match torch: ON, 0.85/0.95);
    # for Adam this cycles beta1 inversely to the lr
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    # polynomial
    power: float = 1.0
    lr_end: float = 1e-7
