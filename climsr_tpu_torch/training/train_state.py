# -*- coding: utf-8 -*-
"""Train state of the pixel-loss pre-training task: the port of
``climsr_tpu.training.train_state.TrainState``. The JAX state is an immutable
pytree of step, params and optimizer state; here the model and the optimizer
hold their tensors and are updated in place."""
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

