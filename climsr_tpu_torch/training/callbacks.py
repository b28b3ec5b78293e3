# -*- coding: utf-8 -*-
"""Trainer callbacks: the part of ``climsr_tpu.training.callbacks`` the loop needs.

A callback is any object with some of these hooks, each called by the
Trainer where the JAX Trainer calls it (``climsr_tpu/training/loop.py``):

- ``on_fit_start(trainer)``,
- ``on_train_batch_end(trainer)`` (opt-in: only callbacks that define it
  cost a call per step),
- ``on_train_epoch_end(trainer, epoch)`` (not for a preempted epoch),
- ``on_validation_end(trainer, epoch, val_metrics)``.

:class:`LogImagesCallback` (``log_images``), :class:`LearningRateMonitor`,
:class:`DeviceStatsMonitor` (CUDA allocator statistics from
``torch.cuda.memory_stats``) and :class:`ModelPruningCallback`
(``model_pruning``, and ``lottery_ticket`` with the rewind) are ported; no
experiment preset of the repo selects a callback.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import climsr_tpu_torch.consts as consts

B = consts.batch_items
logger = logging.getLogger(__name__)

# matplotlib's 256-entry jet, inferno and gray tables (``Colormap._lut[:256, :3]``,
# float64), saved once from matplotlib so the grids need no matplotlib
COLORMAPS_FILE = Path(__file__).with_name("colormaps.npz")
_colormaps: Dict[str, np.ndarray] = {}


def colormap(name: str) -> np.ndarray:
    """A (256, 3) float64 colour table by matplotlib's name."""
    if not _colormaps:
        with np.load(COLORMAPS_FILE) as tables:
            _colormaps.update({k: tables[k] for k in tables.files})
    return _colormaps[name]


def _colorize(arr: np.ndarray, mask: Optional[np.ndarray] = None, cmap_name: str = "jet") -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 with NaN/ocean painted black, as
    matplotlib's ``cmap(np.ma.masked_invalid(norm))`` with ``set_bad("black")``
    colours it: index ``min(int(norm * 256), 255)``, then ``uint8(rgb * 255)``."""
    arr = np.asarray(arr, np.float32).copy()
    if mask is not None:
        arr[mask <= 0] = np.nan
    finite = np.isfinite(arr)
    vmin = np.nanmin(arr[finite]) if finite.any() else 0.0
    vmax = np.nanmax(arr[finite]) if finite.any() else 1.0
    norm = (arr - vmin) / (vmax - vmin + 1e-12)
    bad = ~np.isfinite(norm)  # masked_invalid: NaN and inf
    with np.errstate(invalid="ignore"):
        index = np.clip(np.where(bad, 0, norm) * 256, 0, 255).astype(np.int64)
    rgb = (colormap(cmap_name)[index] * 255).astype(np.uint8)
    rgb[bad] = 0
    return rgb


def make_grid(images: np.ndarray, masks: Optional[np.ndarray], nrow: int = 8, cmap: str = "jet") -> np.ndarray:
    """(N, H, W) stack -> single (GH, GW, 3) uint8 grid image."""
    n, h, w = images.shape[:3]
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * h, ncol * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, ncol)
        m = masks[i] if masks is not None else None
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = _colorize(images[i], m, cmap)
    return grid


class LogImagesCallback:
    """Validation image grids (the reference's LogImagesCallback,
    ``climsr/core/callbacks.py:39-440``; JAX ``climsr_tpu/training/callbacks.py:58-149``).

    After each validation the first ``max_images`` validation samples go
    through the generator (inference mode, so the ESRGAN's blocks run kernel
    A on the card) and six grids are logged: HR, elevation, nearest and
    cubic once (the first validation), SR and |SR - HR| every time, with
    the jet, inferno and gray tables and the ocean black. With
    ``save_figures`` a matplotlib panel per validation goes to
    ``<workdir>/images`` (matplotlib imported in the call). The port runs one
    process, so there is no rank to check.
    """

    def __init__(self, max_images: int = 8, save_figures: bool = False):
        self.max_images = max_images
        self.save_figures = save_figures
        self._static_logged = False

    def on_validation_end(self, trainer, epoch: int, val_metrics: Dict[str, float]) -> None:
        import torch

        from climsr_tpu_torch.data.pipeline import collate, to_nchw
        from climsr_tpu_torch.models import apply_generator_batch

        dataset = trainer.val_loader.dataset
        n = min(self.max_images, len(dataset))
        batch = collate([dataset[i] for i in range(n)])  # the first val batch's first n samples
        with torch.inference_mode():
            sr = apply_generator_batch(trainer.generator_type, trainer.g_model,
                                       {k: to_nchw(batch[k]) for k in (B.lr, B.elevation, B.mask)},
                                       trainer.compute_dtype)
        sr = sr.float().cpu().numpy()[:, 0]
        hr = batch[B.hr][..., 0]
        mask = batch[B.mask][..., 0]
        error = np.abs(sr - hr)

        step = trainer.global_step
        mlog = trainer.metric_logger
        if not self._static_logged:
            mlog.log_image("val/hr_images", make_grid(hr, mask, cmap="jet"), step)
            mlog.log_image("val/elevation", make_grid(batch[B.elevation][..., 0], mask, cmap="inferno"), step)
            mlog.log_image("val/nearest_interpolation", make_grid(batch[B.nearest][..., 0], mask, cmap="jet"), step)
            mlog.log_image("val/cubic_interpolation", make_grid(batch[B.cubic][..., 0], mask, cmap="jet"), step)
            self._static_logged = True
        mlog.log_image("val/sr_images", make_grid(sr, mask, cmap="jet"), step)
        mlog.log_image("val/error", make_grid(error, mask, cmap="gray"), step)

        if self.save_figures:
            self._save_fig(trainer, batch, sr, error, epoch, step)

    def _save_fig(self, trainer, batch, sr, error, epoch: int, step: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img_dir = os.path.join(trainer.workdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        hr = batch[B.hr][..., 0]
        nearest = batch[B.nearest][..., 0]
        cubic = batch[B.cubic][..., 0]
        mask = batch[B.mask][..., 0]
        n = hr.shape[0]
        cols = ["HR", "Interp. Nearest", "Interp. Cubic", "SR", "SR Error"]
        fig, axes = plt.subplots(n, len(cols), figsize=(3 * len(cols), 3 * n), squeeze=False)
        for i in range(n):
            panels = [hr[i], nearest[i], cubic[i], sr[i], error[i]]
            for j, (title, panel) in enumerate(zip(cols, panels)):
                ax = axes[i][j]
                shown = panel.copy()
                shown[mask[i] <= 0] = np.nan
                ax.imshow(shown, cmap="jet")
                ax.set_xticks([])
                ax.set_yticks([])
                if j in (1, 2, 3):
                    diff = (panel - hr[i])[mask[i] > 0]
                    mae = float(np.abs(diff).mean()) if diff.size else 0.0
                    rmse = float(np.sqrt(np.square(diff).mean())) if diff.size else 0.0
                    ax.set_xlabel(f"MAE {mae:.3f} / RMSE {rmse:.3f}", fontsize=8)
                if i == 0:
                    ax.set_title(title)
        out = os.path.join(img_dir, f"figure_epoch={epoch:03d}_step={step:06d}.png")
        fig.savefig(out, bbox_inches="tight", dpi=72)
        plt.close(fig)
        logger.info("Saved validation figure panel to %s", out)


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

    Across ranks both hooks read and write the full weights inside the
    Trainer's ``generator_full_params`` (gathered under ZeRO-3), so every rank
    takes the same masks from the same weights and the shards take the pruned
    values. The per-step masks multiply what the next step reads: each
    sharded parameter's shard (the optimizer's leaf, with the rank's part of
    the mask) and, at ZeRO stages 0-2, the module's full parameter, which the
    next forward reads before the shards are published again; a replicated
    parameter is its own shard and is multiplied once.
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
            with trainer.generator_full_params() as model:
                self._initial = {name: p.detach().float().cpu().numpy().copy()
                                 for name, p in self._prunable(model).items()}

    def on_train_epoch_end(self, trainer, epoch: int) -> None:
        import torch

        with trainer.generator_full_params() as model, torch.no_grad():
            prunable = self._prunable(model)
            if self._masks is None:
                self._masks = {name: np.ones(tuple(p.shape), dtype=bool) for name, p in prunable.items()}
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
            part = trainer.generator_partition
            self._params, self._device_masks = [], []
            for name, p in prunable.items():
                mask = torch.from_numpy(self._masks[name]).to(p.device, p.dtype)
                sharded = part is not None and part.is_sharded(name)
                if sharded:
                    self._params.append(part.shards[name])
                    self._device_masks.append(part.shard_of(name, mask).contiguous())
                if not sharded or part.stage < 3:
                    self._params.append(p)
                    self._device_masks.append(mask)
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


CALLBACK_REGISTRY = {
    "learning_rate_monitor": LearningRateMonitor,
    "device_stats_monitor": DeviceStatsMonitor,
    # the reference's GPUStatsMonitor -> the device-stats monitor
    "gpu_stats_monitor": DeviceStatsMonitor,
    "log_images": LogImagesCallback,
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
