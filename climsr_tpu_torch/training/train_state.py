# -*- coding: utf-8 -*-
"""Train states of the two tasks: the port of ``climsr_tpu.training.train_state``.
The JAX states are immutable pytrees of step, params and optimizer state; here
the models and the optimizers hold their tensors and are updated in place.

Given a ``mesh`` (``parallel.mesh.create_mesh``), a state spans the ranks: each
model gets a :class:`~climsr_tpu_torch.parallel.mesh.ZeroPartition` at
``zero_stage`` (0 is plain data parallelism), its optimizer holds the
partition's leaves (the shards from stage 1 up) and clips by the global
gradient norm. This is the placement of the JAX Trainer's ``_place_state``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from climsr_tpu_torch.parallel.mesh import ZeroPartition
from climsr_tpu_torch.training.optimizers import OptimizerSpec, ScheduledOptimizer


def _place(model: nn.Module, tx: OptimizerSpec, zero_stage: int, mesh, sum_spatial: bool = True):
    if mesh is None:
        if zero_stage:
            raise ValueError(f"ZeRO stage {zero_stage} needs a mesh of several ranks")
        return None, tx(p for p in model.parameters() if p.requires_grad)
    part = ZeroPartition(model, zero_stage, mesh, sum_spatial=sum_spatial)
    opt = tx(part.opt_params)
    opt.norm_fn = part.grad_norm
    return part, opt


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ScheduledOptimizer
    partition: Optional[ZeroPartition] = None

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec, zero_stage: int = 0, mesh=None) -> "TrainState":
        part, opt = _place(model, tx, zero_stage, mesh)
        return cls(step=0, model=model, optimizer=opt, partition=part)


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
    g_partition: Optional[ZeroPartition] = None
    d_partition: Optional[ZeroPartition] = None

    @classmethod
    def create(cls, g_model: nn.Module, g_tx: OptimizerSpec, d_model: nn.Module, d_tx: OptimizerSpec,
               zero_stage: int = 0, mesh=None) -> "GANTrainState":
        """With a ``mesh``, the discriminator's BatchNorm also takes its
        batch statistics over the data axis (the JAX module's global batch),
        and its gradients are summed over the data axis only: under spatial
        sharding every spatial rank runs it on the same whole frames."""
        g_part, g_opt = _place(g_model, g_tx, zero_stage, mesh)
        d_part, d_opt = _place(d_model, d_tx, zero_stage, mesh, sum_spatial=False)
        if d_part is not None:
            from climsr_tpu_torch.models.common import TorchBatchNorm

            for m in d_model.modules():
                if isinstance(m, TorchBatchNorm):
                    m.process_group = d_part.group
        return cls(step=0, g_model=g_model, g_optimizer=g_opt, d_model=d_model, d_optimizer=d_opt,
                   g_partition=g_part, d_partition=d_part)
