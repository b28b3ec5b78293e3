# -*- coding: utf-8 -*-
"""Trainer callbacks: the part of ``climsr_tpu.training.callbacks`` the loop needs.

A callback is any object with some of these hooks, each called by the
Trainer where the JAX Trainer calls it (``climsr_tpu/training/loop.py``):

- ``on_fit_start(trainer)``,
- ``on_train_batch_end(trainer)`` (opt-in: only callbacks that define it
  cost a call per step),
- ``on_train_epoch_end(trainer, epoch)`` (not for a preempted epoch),
- ``on_validation_end(trainer, epoch, val_metrics)``.

:class:`LearningRateMonitor`, :class:`DeviceStatsMonitor` (CUDA allocator
statistics from ``torch.cuda.memory_stats``) and :class:`ModelPruningCallback`
(``model_pruning``, and ``lottery_ticket`` with the rewind) are ported.
``log_images`` (matplotlib grids) raises, naming its ``ROADMAP.md`` item; no
experiment preset of the repo selects a callback.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_NOT_PORTED = "ROADMAP.md, queue 1, item 11: log_images"


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


class ModelPruningCallback:
    """L1-unstructured magnitude pruning of the generator's weights: the port
    of the JAX ``ModelPruningCallback`` (``climsr_tpu/training/callbacks.py:194-300``),
    PL's ``ModelPruning(pruning_fn='l1_unstructured')`` of
    ``conf/callbacks/model_pruning.yaml``.

    At every train-epoch end (before validation, so the epoch's val metrics
    and the checkpoint they rank describe the pruned weights) the host zeroes
    the smallest-|w| ``amount`` of each parameter with ndim >= 2 that is still
    alive, on f32 copies with ``np.partition`` as JAX does, so the masks are
    JAX's; masks are cumulative across epochs (``amount=0.5``: 50%, then 75%).
    With ``use_lottery_ticket_hypothesis`` (``lottery_ticket.yaml``) the
    surviving weights are rewound to their values at ``on_fit_start``. After
    every train step the masks are re-applied on the card, one
    ``torch._foreach_mul_`` under ``no_grad``, so the optimizer cannot move a
    pruned weight off zero; its state is left alone, as in JAX. Both writes
    are in place on the parameters (``copy_`` and ``mul_``), which bumps their
    version counters: the ESRGAN blocks' packed kernel weights, cached by
    (data pointer, version), are then packed anew, so kernels A, B1 and B2
    never run on unpruned weights.
    """

    def __init__(self, amount: float = 0.5, use_lottery_ticket_hypothesis: bool = False):
        self.amount = float(amount)
        self.use_lottery_ticket_hypothesis = use_lottery_ticket_hypothesis
        self._masks: Optional[Dict[str, np.ndarray]] = None
        self._initial: Optional[Dict[str, np.ndarray]] = None
        self._params: List = []
        self._device_masks: List = []
        self.sparsity = 0.0  # share of the prunable weights at zero after the last pruning

    @staticmethod
    def _prunable(model) -> Dict[str, "object"]:
        return {name: p for name, p in model.named_parameters() if p.ndim >= 2}  # kernels, not biases

    def on_fit_start(self, trainer) -> None:
        if self.use_lottery_ticket_hypothesis:
            self._initial = {name: p.detach().float().cpu().numpy().copy()
                             for name, p in self._prunable(trainer.g_model).items()}

    def on_train_epoch_end(self, trainer, epoch: int) -> None:
        import torch

        prunable = self._prunable(trainer.g_model)
        if self._masks is None:
            self._masks = {name: np.ones(tuple(p.shape), dtype=bool) for name, p in prunable.items()}
        with torch.no_grad():
            for name, p in prunable.items():  # JAX's prune(), leaf by leaf
                mask = self._masks[name]
                w = p.detach().float().cpu().numpy()
                alive = np.abs(w)[mask]
                if alive.size == 0:
                    new = w * mask
                else:
                    k = int(alive.size * self.amount)
                    if k > 0:
                        thresh = np.partition(alive, k - 1)[k - 1]
                        mask = mask & (np.abs(w) > thresh)
                    src = self._initial[name] if self._initial is not None else w
                    new = np.where(mask, src, 0.0)
                self._masks[name] = mask
                p.copy_(torch.from_numpy(np.ascontiguousarray(new, dtype=np.float32)))
        self._params = list(prunable.values())
        self._device_masks = [torch.from_numpy(self._masks[name]).to(p.device, p.dtype)
                              for name, p in prunable.items()]
        total = sum(m.size for m in self._masks.values())
        self.sparsity = sum(int((~m).sum()) for m in self._masks.values()) / max(1, total)
        logger.info("Pruned generator to %.1f%% sparsity%s", 100.0 * self.sparsity,
                    " (lottery-ticket rewind)" if self.use_lottery_ticket_hypothesis else "")

    def on_train_batch_end(self, trainer) -> None:
        if not self._params:
            return
        import torch

        with torch.no_grad():
            torch._foreach_mul_(self._params, self._device_masks)


def _lottery_ticket() -> ModelPruningCallback:
    return ModelPruningCallback(use_lottery_ticket_hypothesis=True)


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
    "model_pruning": ModelPruningCallback,
    "lottery_ticket": _lottery_ticket,
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
