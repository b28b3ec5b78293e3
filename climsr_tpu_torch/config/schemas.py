# -*- coding: utf-8 -*-
"""Config schemas: copies of ``climsr_tpu/config/schemas.py`` with the same
fields and defaults — the optimizer and scheduler (``:137-166``), the
generator, the discriminator and the task with its GAN fields (``:236-287``,
``conf/task/gan_training.yaml``). The other schemas come with the inference
CLI and config composer (``ROADMAP.md``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

MISSING = "???"


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


@dataclass
class GeneratorConfig:
    name: str = MISSING
    in_channels: int = 3
    out_channels: int = 1
    scaling_factor: int = 4
    # family-specific knobs (ignored by families that don't use them)
    nf: int = 64
    nb: int = 23
    gc: int = 32
    n_resgroups: int = 10
    n_resblocks: int = 20
    n_feats: int = 64
    reduction: int = 16
    num_rrdb_blocks: int = 16
    num_rrfdb_blocks: int = 8
    # the JAX package's Pallas switch; the port takes it for config parity
    # and runs its CUDA kernels on the card whatever its value
    use_pallas: Optional[bool] = None


@dataclass
class DiscriminatorConfig:
    name: str = "default"
    in_channels: int = 1


@dataclass
class TaskConfig:
    name: str = "generator_pre_training"  # or "gan_training"
    generator: Optional[GeneratorConfig] = None
    discriminator: Optional[DiscriminatorConfig] = None
    optimizers: Optional[Dict[str, Optional[OptimizerConfig]]] = None
    schedulers: Optional[Dict[str, Optional[SchedulerConfig]]] = None
    initial_hp_metric_val: float = 5e-3
    # GAN loss weights (conf/task/gan_training.yaml)
    pixel_level_loss_factor: float = 0.01
    perceptual_loss_factor: float = 1.0
    adversarial_loss_factor: float = 0.005
    # the reference keeps the VGG perceptual loss under no_grad
    # (perceptual.py:23); True backpropagates through it
    differentiable_perceptual: bool = False
    # VGG truncation depth; the reference uses features[:35] == conv5_4
    perceptual_cutoff: str = "conv5_4"
    # compute the perceptual term every k-th step only (1 = every step, the
    # reference); under the no-grad term only the logged value changes
    perceptual_interval: int = 1
