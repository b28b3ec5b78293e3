# -*- coding: utf-8 -*-
"""Instantiator facade: config -> constructed objects.

The port of ``climsr_tpu.config.instantiator`` (reference
``climsr/core/instantiator.py``, ``HydraInstantiator``): explicit registries
(models, optimizers, schedules) behind one object with the reference's verbs,
``model`` / ``discriminator`` / ``optimizer`` / ``scheduler`` /
``data_module`` / ``instantiate``. Configs are plain data, so nothing is
pickled into checkpoints to rebuild them. ``device`` (``None`` means
``cuda``) is where models land and where an optimizer's parameters must be.
"""
from __future__ import annotations

from typing import Any, Optional

from climsr_tpu_torch.config.schemas import (
    DiscriminatorConfig,
    GeneratorConfig,
    OptimizerConfig,
    SchedulerConfig,
    SuperResolutionDataConfig,
    from_dict,
)
from climsr_tpu_torch.device import DeviceLike

GENERATOR_KWARGS = (
    "in_channels", "out_channels", "scaling_factor", "nf", "nb", "gc",
    "n_resgroups", "n_resblocks", "n_feats", "reduction",
    "num_rrdb_blocks", "num_rrfdb_blocks",
)


class Instantiator:
    def instantiate(self, cfg, **kwargs):
        raise NotImplementedError


class RegistryInstantiator(Instantiator):
    """Builds the port's objects from typed configs or config dicts."""

    def model(self, generator_cfg, dtype=None, device: DeviceLike = None, **overrides):
        from climsr_tpu_torch.models import create_generator

        if isinstance(generator_cfg, dict):
            generator_cfg = from_dict(GeneratorConfig, generator_cfg)
        kwargs = {k: getattr(generator_cfg, k) for k in GENERATOR_KWARGS}
        kwargs.update(overrides)
        return create_generator(generator_cfg.name, dtype=dtype, device=device, **kwargs)

    def discriminator(self, cfg, dtype=None, device: DeviceLike = None, **overrides):
        from climsr_tpu_torch.models import create_discriminator

        if isinstance(cfg, dict):
            cfg = from_dict(DiscriminatorConfig, cfg)
        return create_discriminator(cfg.name, dtype=dtype, device=device, in_channels=cfg.in_channels, **overrides)

    def optimizer(self, cfg, schedule=None, gradient_clip_val: float = 0.0, accumulate_grad_batches: int = 1,
                  device: DeviceLike = None):
        from climsr_tpu_torch.training.optimizers import build_optimizer

        if isinstance(cfg, dict):
            cfg = from_dict(OptimizerConfig, cfg)
        schedule = schedule if schedule is not None else (lambda step: cfg.lr)
        return build_optimizer(cfg, schedule, gradient_clip_val, accumulate_grad_batches, device=device)

    def scheduler(self, cfg, base_lr: float, num_training_steps: int):
        from climsr_tpu_torch.training.schedules import resolve_schedule

        if isinstance(cfg, dict):
            cfg = from_dict(SchedulerConfig, cfg)
        return resolve_schedule(cfg, base_lr, num_training_steps)

    def data_module(self, cfg, tables=None):
        from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule

        if isinstance(cfg, dict):
            cfg = from_dict(SuperResolutionDataConfig, cfg.get("cfg", cfg))
        return SuperResolutionDataModule(cfg, tables=tables)

    def instantiate(self, cfg, **kwargs) -> Optional[Any]:
        """Dispatch by config type (GeneratorConfig, DiscriminatorConfig, OptimizerConfig)."""
        if cfg is None:
            return None
        if isinstance(cfg, GeneratorConfig):
            return self.model(cfg, **kwargs)
        if isinstance(cfg, DiscriminatorConfig):
            return self.discriminator(cfg, **kwargs)
        if isinstance(cfg, OptimizerConfig):
            return self.optimizer(cfg, **kwargs)
        raise TypeError(f"Don't know how to instantiate {type(cfg).__name__}")


default_instantiator = RegistryInstantiator()
