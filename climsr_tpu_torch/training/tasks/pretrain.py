# -*- coding: utf-8 -*-
"""Pixel-loss pre-training task: the port of ``climsr_tpu.training.tasks.pretrain``.

Reference ``climsr/task/pl_generator_pre_training.py`` + ``climsr/core/task.py``:

- loss = MSE for srcnn, L1 otherwise (``task.py:141``),
- the train step: the pixel loss of (sr, hr), its gradient, one optimizer
  update (``pl_generator_pre_training.py:18-33``),
- the val/test step: denormalize, zero ocean pixels with the mask, the pixel
  loss and the 16-metric suite (``task.py:262-300``).

The forward computes in ``compute_dtype`` (bf16 by default) with float32
parameters; the loss and ``grad_norm`` are taken in float32 on the raw
gradients, as in the JAX step. On the card the ESRGAN trunk runs kernels B1
and B2 and the fusion head's input gradient kernel C; the eval step, under
``torch.inference_mode``, runs kernel A. Batches are NCHW dicts (``lr``,
``hr``, ``elevation``, ``mask``; for eval also ``min``, ``max``,
``original_data``) on any device; they are moved to the model's device.

As in the JAX step, ``store`` makes the batch an index vector gathered from a
device-resident tile store, and ``augment`` flips, rotates and assembles the
LR input inside the step (``ops/augment.py``), with draws seeded from
``(augment_seed, state.step)`` (:func:`prepare_batch`). ZeRO partitioning and
spatial sharding are a later item of ``ROADMAP.md`` (queue 1, item 8) and
raise here.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.normalization import minmax_denormalize, zscore_denormalize
from climsr_tpu_torch.data.pipeline import gather
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.metrics.suite import compute_metric_suite
from climsr_tpu_torch.models import apply_generator_batch
from climsr_tpu_torch.ops.augment import augment_and_assemble, step_generator
from climsr_tpu_torch.training.train_state import TrainState

B = consts.batch_items

_LATER = {
    "zero": "ROADMAP.md, queue 1, item 8: multi-GPU (DDP / ZeRO)",
    "spatial": "ROADMAP.md, queue 1, item 8: multi-GPU (H-sharded halo exchange)",
}


def pixel_loss_fn(generator_type: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if generator_type == consts.models.srcnn:
        return lambda sr, hr: torch.mean(torch.square(sr - hr))
    return lambda sr, hr: torch.mean(torch.abs(sr - hr))


def refuse_later_options(step_name: str, **options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"{step_name}({name}=...) is not ported yet: {_LATER[name]}")


def prepare_batch(batch, step: int, generator_type: str, augment: Optional[Dict], augment_seed: int,
                  store: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The JAX step's first lines (``climsr_tpu/training/tasks/pretrain.py:102-109``):
    gather the index batch from ``store``, then augment and assemble with
    draws from ``(augment_seed, step)`` on the batch's device."""
    if store is not None:
        where = next(iter(store.values())).device
        batch = gather(store, torch.as_tensor(batch, dtype=torch.int64).to(where))
    if augment is not None:
        gen = step_generator(augment_seed, step, batch[B.hr].device)
        batch = augment_and_assemble(batch, gen, generator_type, **augment)
    return batch


def check_device(model: nn.Module, device: DeviceLike) -> None:
    """``device=None`` means ``cuda``: raises without a card, or where the model is elsewhere."""
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"the model is on {where}, the step was asked to run on {dev}")


def make_pretrain_step(
    model: nn.Module,
    generator_type: str,
    compute_dtype: torch.dtype = torch.bfloat16,
    augment: Optional[Dict] = None,
    augment_seed: int = 0,
    store: Optional[Dict] = None,
    zero: Optional[Dict] = None,
    spatial: Optional[Dict] = None,
    device: DeviceLike = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, {"train/loss", "grad_norm"})``: one
    forward, backward and optimizer update of ``state.model``, in place (the
    state carries the optimizer: ``TrainState.create(model, tx)``).
    ``augment`` (``augment_and_assemble``'s keyword arguments) takes raw
    {hr, elevation, mask} tiles; ``store`` ({hr, elevation, mask} tensors on
    the device) takes an index vector for ``batch``. ``device`` (``None``
    means ``cuda``) is where the model must be."""
    refuse_later_options("make_pretrain_step", zero=zero, spatial=spatial)
    check_device(model, device)
    loss_fn = pixel_loss_fn(generator_type)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = prepare_batch(batch, state.step, generator_type, augment, augment_seed, store)
        state.optimizer.zero_grad()
        sr = apply_generator_batch(generator_type, state.model, batch, compute_dtype)
        hr = batch[B.hr].to(device=sr.device, dtype=torch.float32)
        loss = loss_fn(sr.float(), hr)
        loss.backward()
        grads = [p.grad for p in state.optimizer.params if p.grad is not None]
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        state.optimizer.step()
        state.step += 1
        return state, {"train/loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_eval_step(
    model: nn.Module,
    generator_type: str,
    normalization_method: str = "minmax",
    normalization_range: Tuple[float, float] = (-1.0, 1.0),
    zscore_mean: float = 0.0,
    zscore_std: float = 1.0,
    compute_dtype: torch.dtype = torch.bfloat16,
    prefix: str = consts.stages.val,
    device: DeviceLike = None,
) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: the reference's common_val_test_step on the
    model as it stands (16 metrics + ``{prefix}/normalized_loss`` and
    ``{prefix}/loss``), under ``torch.inference_mode``. ``device`` (``None``
    means ``cuda``) is where the model must be."""
    check_device(model, device)
    loss_fn = pixel_loss_fn(generator_type)

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        sr = apply_generator_batch(generator_type, model, batch, compute_dtype).float()

        def get(key):
            return torch.as_tensor(batch[key]).to(device=sr.device, dtype=torch.float32)

        hr, mask, original = get(B.hr), get(B.mask), get(B.original_data)
        if normalization_method == "zscore":
            denormalized_sr = zscore_denormalize(sr, zscore_mean, zscore_std)
        else:
            denormalized_sr = minmax_denormalize(sr, get(B.min), get(B.max), feature_range=normalization_range)

        sr_masked = sr * mask
        hr_masked = hr * mask
        denormalized_sr = denormalized_sr * mask
        original_masked = original * mask

        loss = loss_fn(sr_masked, hr_masked)
        metric_dict = compute_metric_suite(sr_masked, hr_masked, denormalized_sr, original_masked, mode=prefix)
        metric_dict[f"{prefix}/normalized_loss"] = loss
        metric_dict[f"{prefix}/loss"] = loss
        return metric_dict

    return step
