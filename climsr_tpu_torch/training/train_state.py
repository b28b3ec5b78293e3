# -*- coding: utf-8 -*-
"""Train states of the two tasks: the port of ``climsr_tpu.training.train_state``.
The JAX states are immutable pytrees of step, params and optimizer state; here
the models and the optimizers hold their tensors and are updated in place."""
from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from climsr_tpu_torch.training.optimizers import OptimizerSpec, ScheduledOptimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ScheduledOptimizer

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec) -> "TrainState":
        return cls(step=0, model=model, optimizer=tx(p for p in model.parameters() if p.requires_grad))


@dataclass
class GANTrainState:
    """Generator and discriminator with their optimizers (relativistic GAN
    task). The discriminator's BatchNorm running statistics, JAX's
    ``d_batch_stats``, are its buffers, updated in place by each train-mode
    forward."""

    step: int
    g_model: nn.Module
    g_optimizer: ScheduledOptimizer
    d_model: nn.Module
    d_optimizer: ScheduledOptimizer

    @classmethod
    def create(cls, g_model: nn.Module, g_tx: OptimizerSpec, d_model: nn.Module, d_tx: OptimizerSpec) -> "GANTrainState":
        return cls(step=0, g_model=g_model, g_optimizer=g_tx(p for p in g_model.parameters() if p.requires_grad),
                   d_model=d_model, d_optimizer=d_tx(p for p in d_model.parameters() if p.requires_grad))
