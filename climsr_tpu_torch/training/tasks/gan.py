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
``augment`` and ``store`` work as in the pre-training step
(:func:`~climsr_tpu_torch.training.tasks.pretrain.prepare_batch`).

Across ranks (``GANTrainState.create(..., mesh=)``, ``zero={"stage": s}`` as
in the pre-training step) each rank runs its slice of the global batch, and
the step is the single-process step on the global batch: the relativistic
losses centre on the global mean scores (a differentiable all-reduce), each
loss term is the rank's share of its global mean, the discriminator's
BatchNorm takes the global batch statistics, and both models' gradients are
summed by their ``ZeroPartition``. ``spatial`` (the pre-training step's
dict) runs the generator H-sharded (``climsr_tpu/training/tasks/gan.py:60-100``):
its rows of ``sr`` are all-gathered into whole frames (``parallel.halo.gather_rows``,
whose backward keeps the rank's own rows of the identical whole-frame
gradient), so every spatial rank runs D and VGG on the same frames; D's
gradients are then summed over the data axis only, G's over the world.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.device import DeviceLike
from climsr_tpu_torch.losses.gan import relativistic_d_loss, relativistic_g_loss
from climsr_tpu_torch.models import apply_generator_batch
from climsr_tpu_torch.parallel.mesh import all_reduce_sum, shard_samples
from climsr_tpu_torch.training.tasks.pretrain import (
    check_device,
    check_parallel_options,
    check_partition,
    prepare_batch,
    reduced,
)
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
    augment_seed: int = 0,
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
    check_parallel_options("make_gan_step", zero, spatial)
    check_device(g_model, device)
    check_device(d_model, device)
    sharded_fwd = None
    if spatial is not None:
        from climsr_tpu_torch.parallel.halo import gather_rows, spatial_sharded_model_forward

        sharded_fwd = spatial_sharded_model_forward(g_model, generator_type, **spatial)

    def forward_g(g: nn.Module, batch: Dict) -> torch.Tensor:
        if sharded_fwd is None:
            return apply_generator_batch(generator_type, g, batch, compute_dtype).float()
        dev = next(g.parameters()).device
        args = [batch[k].to(device=dev, dtype=compute_dtype).contiguous(memory_format=torch.channels_last)
                for k in (B.lr, B.elevation, B.mask) if k in batch]
        rows_sr, rows = sharded_fwd(*args)
        per = sharded_fwd.rows_per_rank(args[0].shape[2])
        return gather_rows(rows_sr.float(), rows, spatial["mesh"], spatial.get("axis", "spatial"), per,
                           batch[B.hr].shape[2])

    def step(state: GANTrainState, batch: Dict) -> Tuple[GANTrainState, Metrics]:
        gp, dp = state.g_partition, state.d_partition
        check_partition("make_gan_step", gp, zero)
        batch = prepare_batch(batch, state.step, generator_type, augment, augment_seed, store,
                              mesh=None if gp is None else gp.mesh)
        data = gp is not None and gp.size > 1  # the batch is split over a data axis

        def metric(v: torch.Tensor) -> torch.Tensor:  # a share summed over the data axis
            return reduced(v, gp, gp.group) if data else v.detach()

        if not data:
            mean = center = torch.mean
            share = 1.0
        else:
            n_global = batch[B.hr].shape[0] * gp.size
            share = batch[B.hr].shape[0] / n_global

            def mean(t: torch.Tensor) -> torch.Tensor:  # the rank's share of the global mean
                return t.sum() / (t.numel() * gp.size)

            def center(t: torch.Tensor) -> torch.Tensor:  # the global mean
                return all_reduce_sum(t.sum(), gp.group) / (t.numel() * gp.size)

        d_ctx = nullcontext() if dp is None else dp.gathered()
        d = state.d_model.train()
        # ---- generator update: D's parameters take no gradient
        state.g_optimizer.zero_grad()
        _requires_grad(d, dp, False)
        with nullcontext() if gp is None else gp.gathered():
            sr = forward_g(state.g_model, batch)
        hr = batch[B.hr].to(device=sr.device, dtype=torch.float32)
        with d_ctx:
            score_real = _apply_d(d, hr, compute_dtype)
            score_fake = _apply_d(d, sr, compute_dtype)
        adversarial = relativistic_g_loss(score_real, score_fake, mean, center)
        pixel = mean(torch.abs(sr - hr))
        if perceptual_fn is not None and state.step % perceptual_interval == 0:
            perceptual = perceptual_fn(sr, hr).float() * share
        else:
            perceptual = torch.zeros((), device=sr.device)
        loss_g = pixel_weight * pixel + perceptual_weight * perceptual + adversarial_weight * adversarial
        loss_g.backward()
        if gp is not None:
            gp.reduce_gradients()
        state.g_optimizer.step()
        if gp is not None:
            gp.publish()
        _requires_grad(d, dp, True)

        # ---- discriminator update on the same sr, detached
        state.d_optimizer.zero_grad()
        with nullcontext() if dp is None else dp.gathered():
            loss_d = relativistic_d_loss(_apply_d(d, hr, compute_dtype), _apply_d(d, sr.detach(), compute_dtype),
                                         mean, center)
        loss_d.backward()
        if dp is not None:
            dp.reduce_gradients()
        state.d_optimizer.step()
        if dp is not None:
            dp.publish()
        state.step += 1
        return state, {
            "train/loss_G": metric(loss_g),
            "train/loss_D": metric(loss_d),
            "train/pixel_level_loss": metric(pixel),
            "train/adversarial_loss": metric(adversarial),
            "train/perceptual_loss": metric(perceptual),
        }

    return step


def _requires_grad(d: nn.Module, partition, flag: bool) -> None:
    d.requires_grad_(flag)
    if partition is not None:
        for s in partition.opt_params:
            s.requires_grad_(flag)


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
    models must be. Across ranks every rank passes the whole batch; the
    generator and D run on each rank's share of the samples, as in
    ``make_eval_step``, and the perceptual term on the whole batch."""
    check_device(g_model, device)
    check_device(d_model, device)

    def generate(batch: Dict) -> torch.Tensor:
        return apply_generator_batch(generator_type, g_model, batch, compute_dtype).float()

    def scores(pair: Dict) -> torch.Tensor:
        return torch.cat([_apply_d(d_model, pair["hr"], compute_dtype), _apply_d(d_model, pair["sr"], compute_dtype)],
                         dim=1)

    @torch.inference_mode()
    def val_losses(batch: Dict) -> Metrics:
        sr = shard_samples(generate, batch)
        hr = batch[B.hr].to(device=sr.device, dtype=torch.float32)
        if B.mask in batch:
            hr = torch.where(batch[B.mask].to(device=sr.device, dtype=torch.float32) > 0, hr, 0.0)
        was_training = d_model.training
        d_model.eval()
        try:
            d_hr, d_sr = shard_samples(scores, {"hr": hr, "sr": sr}).chunk(2, dim=1)
        finally:
            d_model.train(was_training)
        adversarial = relativistic_g_loss(d_hr, d_sr)
        pixel = torch.mean(torch.abs(sr - hr))
        perceptual = perceptual_fn(sr, hr).float() if perceptual_fn is not None else torch.zeros((), device=sr.device)
        loss_g = pixel_weight * pixel + perceptual_weight * perceptual + adversarial_weight * adversarial
        return {"val/perceptual_loss": perceptual, "val/adversarial_loss": adversarial, "val/loss_G": loss_g}

    return val_losses
