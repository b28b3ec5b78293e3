# -*- coding: utf-8 -*-
"""Relativistic GAN fine-tune: the port of ``climsr_tpu.training.tasks.gan``.

Reference ``climsr/task/pl_gan.py``, two optimizers; one call of the step is
the generator sub-step and then the discriminator sub-step, as the JAX step
fuses them (``gan.py:121-205``):

- G: ``loss_G = 0.01 * pixel L1 + 1.0 * perceptual + 0.005 * adversarial``
  (``conf/task/gan_training.yaml``), its gradient to G's parameters only (D's
  parameters are frozen for the sub-step, so they receive none), one update
  of G's optimizer;
- D: the relativistic D loss on (hr, the G sub-step's ``sr`` detached); there
  is no second generator forward (``gan.py:174-183``); one update of D's
  optimizer;
- D runs in train mode four times per step, in the order hr, sr, hr,
  sr detached, each forward updating its BatchNorm running statistics;
- the perceptual term is computed when ``step % perceptual_interval == 0`` and
  is 0.0 otherwise (``gan.py:143-157``).

The forwards compute in ``compute_dtype`` (bf16 by default) with float32
parameters; losses are float32. On the card the generator runs kernels B1
and B2 (33 each per step at nb=11) and the fusion head's kernel C once per
step; :func:`make_gan_val_losses`, under ``torch.inference_mode``, runs kernel
A. Batches are NCHW dicts on any device, moved to the models' device.
Augmentation, the device-resident store, ZeRO and spatial sharding raise,
naming their ``ROADMAP.md`` items, as the pre-training step does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.device import DeviceLike
from climsr_tpu_torch.losses.gan import relativistic_d_loss, relativistic_g_loss
from climsr_tpu_torch.models import apply_generator_batch
from climsr_tpu_torch.training.tasks.pretrain import check_device, refuse_later_options
from climsr_tpu_torch.training.train_state import GANTrainState

B = consts.batch_items

Metrics = Dict[str, torch.Tensor]


def _apply_d(d_model: nn.Module, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return d_model(x.to(compute_dtype).contiguous(memory_format=torch.channels_last)).float()


def make_gan_step(
    g_model: nn.Module,
    d_model: nn.Module,
    generator_type: str,
    pixel_weight: float = 0.01,
    perceptual_weight: float = 1.0,
    adversarial_weight: float = 0.005,
    perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    perceptual_interval: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
    augment: Optional[Dict] = None,
    store: Optional[Dict] = None,
    zero: Optional[Dict] = None,
    spatial: Optional[Dict] = None,
    device: DeviceLike = None,
) -> Callable[[GANTrainState, Dict], Tuple[GANTrainState, Metrics]]:
    """``step(state, batch) -> (state, metrics)``: one G and one D update of
    ``state``'s models, in place (``GANTrainState.create(g, g_tx, d, d_tx)``).
    Metrics: ``train/loss_G``, ``train/loss_D``, ``train/pixel_level_loss``,
    ``train/adversarial_loss``, ``train/perceptual_loss``. ``device``
    (``None`` means ``cuda``) is where both models must be."""
    refuse_later_options("make_gan_step", augment=augment, store=store, zero=zero, spatial=spatial)
    check_device(g_model, device)
    check_device(d_model, device)

    def step(state: GANTrainState, batch: Dict) -> Tuple[GANTrainState, Metrics]:
        d = state.d_model.train()
        # ---- generator update: D's parameters take no gradient
        state.g_optimizer.zero_grad()
        d.requires_grad_(False)
        sr = apply_generator_batch(generator_type, state.g_model, batch, compute_dtype).float()
        hr = batch[B.hr].to(device=sr.device, dtype=torch.float32)
        score_real = _apply_d(d, hr, compute_dtype)
        score_fake = _apply_d(d, sr, compute_dtype)
        adversarial = relativistic_g_loss(score_real, score_fake)
        pixel = torch.mean(torch.abs(sr - hr))
        if perceptual_fn is not None and state.step % perceptual_interval == 0:
            perceptual = perceptual_fn(sr, hr).float()
        else:
            perceptual = torch.zeros((), device=sr.device)
        loss_g = pixel_weight * pixel + perceptual_weight * perceptual + adversarial_weight * adversarial
        loss_g.backward()
        state.g_optimizer.step()
        d.requires_grad_(True)

        # ---- discriminator update on the same sr, detached
        state.d_optimizer.zero_grad()
        loss_d = relativistic_d_loss(_apply_d(d, hr, compute_dtype), _apply_d(d, sr.detach(), compute_dtype))
        loss_d.backward()
        state.d_optimizer.step()
        state.step += 1
        return state, {
            "train/loss_G": loss_g.detach(),
            "train/loss_D": loss_d.detach(),
            "train/pixel_level_loss": pixel.detach(),
            "train/adversarial_loss": adversarial.detach(),
            "train/perceptual_loss": perceptual.detach(),
        }

    return step


def make_gan_val_losses(
    g_model: nn.Module,
    d_model: nn.Module,
    generator_type: str,
    pixel_weight: float = 0.01,
    perceptual_weight: float = 1.0,
    adversarial_weight: float = 0.005,
    perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> Callable[[Dict], Metrics]:
    """``val_losses(batch) -> {"val/perceptual_loss", "val/adversarial_loss",
    "val/loss_G"}`` on the models as they stand (reference
    ``pl_gan.py:99-131``), under ``torch.inference_mode`` with D in eval mode
    (its running statistics; its mode is restored after). As the reference's
    validation step, ocean pixels of ``hr`` (mask 0) are zeroed and ``sr`` is
    not (``gan.py:233-238``). ``device`` (``None`` means ``cuda``) is where both
    models must be."""
    check_device(g_model, device)
    check_device(d_model, device)

    @torch.inference_mode()
    def val_losses(batch: Dict) -> Metrics:
        sr = apply_generator_batch(generator_type, g_model, batch, compute_dtype).float()
        hr = batch[B.hr].to(device=sr.device, dtype=torch.float32)
        if B.mask in batch:
            hr = torch.where(batch[B.mask].to(device=sr.device, dtype=torch.float32) > 0, hr, 0.0)
        was_training = d_model.training
        d_model.eval()
        try:
            adversarial = relativistic_g_loss(_apply_d(d_model, hr, compute_dtype), _apply_d(d_model, sr, compute_dtype))
        finally:
            d_model.train(was_training)
        pixel = torch.mean(torch.abs(sr - hr))
        perceptual = perceptual_fn(sr, hr).float() if perceptual_fn is not None else torch.zeros((), device=sr.device)
        loss_g = pixel_weight * pixel + perceptual_weight * perceptual + adversarial_weight * adversarial
        return {"val/perceptual_loss": perceptual, "val/adversarial_loss": adversarial, "val/loss_G": loss_g}

    return val_losses
