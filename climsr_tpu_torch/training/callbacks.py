# -*- coding: utf-8 -*-
"""Trainer callbacks: the part of ``climsr_tpu.training.callbacks`` the loop needs.

A callback is any object with some of these hooks, each called by the
Trainer where the JAX Trainer calls it (``climsr_tpu/training/loop.py``):

- ``on_fit_start(trainer)``,
- ``on_train_batch_end(trainer)`` (opt-in: only callbacks that define it
  cost a call per step),
- ``on_train_epoch_end(trainer, epoch)`` (not for a preempted epoch),
- ``on_validation_end(trainer, epoch, val_metrics)``.

:class:`LearningRateMonitor` and :class:`DeviceStatsMonitor` (CUDA allocator
statistics from ``torch.cuda.memory_stats``) are ported. ``log_images``
(matplotlib grids), ``model_pruning`` and ``lottery_ticket`` raise,
naming their ``ROADMAP.md`` item; no experiment preset of the repo selects a
callback.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_NOT_PORTED = "ROADMAP.md, queue 1, item 11: the remaining callbacks"


class LearningRateMonitor:
    """Logs the generator LR each validation (reference learning_rate_monitor.yaml)."""

    def on_validation_end(self, trainer, epoch: int, val_metrics: Dict[str, float]) -> None:
        # global_step counts MICRO-batches; the schedule advances once per
        # optimizer step, so divide by the accumulation factor
        opt_step = trainer.global_step // max(1, getattr(trainer, "_accum", 1))
        trainer.metric_logger.log_metrics(
            {"lr-generator": float(trainer.g_schedule(opt_step))}, trainer.global_step
        )


class DeviceStatsMonitor:
    """Logs the card's allocator statistics each validation (the reference's
    GPUStatsMonitor, ``conf/callbacks/gpu_stats_monitor.yaml``): bytes in use,
    peak bytes in use and their share of the card's memory, in GiB."""

    def on_validation_end(self, trainer, epoch: int, val_metrics: Dict[str, float]) -> None:
        import torch

        dev = trainer.device
        if dev.type != "cuda":
            logger.debug("device memory stats are read on CUDA only")
            return
        m = torch.cuda.memory_stats(dev)
        gib = 1 / 2**30
        in_use = m.get("allocated_bytes.all.current", 0)
        stats = {
            "device_stats/dev0/bytes_in_use_gib": in_use * gib,
            "device_stats/dev0/peak_bytes_in_use_gib": m.get("allocated_bytes.all.peak", 0) * gib,
            "device_stats/dev0/utilization": in_use / torch.cuda.get_device_properties(dev).total_memory,
        }
        trainer.metric_logger.log_metrics(stats, trainer.global_step)


def _not_ported(name: str):
    def build():
        raise NotImplementedError(f"callback '{name}' is not ported yet: {_NOT_PORTED}")

    return build


CALLBACK_REGISTRY = {
    "learning_rate_monitor": LearningRateMonitor,
    "device_stats_monitor": DeviceStatsMonitor,
    # the reference's GPUStatsMonitor -> the device-stats monitor
    "gpu_stats_monitor": DeviceStatsMonitor,
    "log_images": _not_ported("log_images"),
    "model_pruning": _not_ported("model_pruning"),
    "lottery_ticket": _not_ported("lottery_ticket"),
}

# config names that are first-class Trainer features, not callback objects
_TRAINER_LEVEL_CALLBACKS = {"early_stopping", "model_checkpoint"}


def build_callbacks(names: Optional[List[str]]) -> List:
    out = []
    for name in names or []:
        if name in CALLBACK_REGISTRY:
            out.append(CALLBACK_REGISTRY[name]())
        elif name not in _TRAINER_LEVEL_CALLBACKS:
            # a typo'd callback silently vanishing costs a whole training run
            raise KeyError(
                f"Unknown callback {name!r}. Available: "
                f"{sorted(CALLBACK_REGISTRY) + sorted(_TRAINER_LEVEL_CALLBACKS)}"
            )
    return out
