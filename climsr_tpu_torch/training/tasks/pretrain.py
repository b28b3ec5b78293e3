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
``(augment_seed, state.step)`` (:func:`prepare_batch`).

Across ranks (a state made with a mesh, ``TrainState.create(..., mesh=)``)
every rank passes the same global batch; the step takes the rank's slice of
the data axis (the augmentation draws are made for the global batch, then
sliced), its loss is its share of the global mean, and the state's
:class:`~climsr_tpu_torch.parallel.mesh.ZeroPartition` sums the gradients
over the world, takes the global ``grad_norm`` and places the update by the
ZeRO stage: ``zero={"stage": s}`` names the stage the state was made with
(stage 2 reduce-scatters the gradients, stage 3 gathers the sharded
parameters on use). ``spatial`` (``mesh``, ``axis``, ``halo``, ``scale``;
the batch is already the rank's slice of the data axis) runs the generator
H-sharded through ``parallel.halo.spatial_sharded_model_forward``; each
rank's loss is then over its rows of the frames.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.normalization import minmax_denormalize, zscore_denormalize
from climsr_tpu_torch.data.pipeline import gather
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.metrics.suite import compute_metric_suite
from climsr_tpu_torch.models import apply_generator_batch
from climsr_tpu_torch.ops.augment import augment_and_assemble, draw_flags, step_generator
from climsr_tpu_torch.parallel.mesh import process_local_slice, shard_samples
from climsr_tpu_torch.training.optimizers import global_norm
from climsr_tpu_torch.training.train_state import TrainState
from climsr_tpu_torch.utils.profiling import span

B = consts.batch_items

_SPATIAL_KEYS = {"mesh", "axis", "halo", "scale"}


def pixel_loss_fn(generator_type: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if generator_type == consts.models.srcnn:
        return lambda sr, hr: torch.mean(torch.square(sr - hr))
    return lambda sr, hr: torch.mean(torch.abs(sr - hr))


def check_parallel_options(step_name: str, zero: Optional[Dict], spatial: Optional[Dict]) -> None:
    """``zero`` is ``{"stage": 0-3}``; ``spatial`` holds ``mesh`` and any of
    ``axis``, ``halo``, ``scale``. Anything else raises."""
    if zero is not None:
        if not isinstance(zero, dict) or set(zero) != {"stage"} or zero["stage"] not in (0, 1, 2, 3):
            raise ValueError(f"{step_name}(zero=...) takes {{'stage': 0-3}}, got {zero!r}")
    if spatial is not None:
        if not isinstance(spatial, dict) or "mesh" not in spatial or set(spatial) - _SPATIAL_KEYS:
            raise ValueError(f"{step_name}(spatial=...) takes 'mesh' and any of {sorted(_SPATIAL_KEYS - {'mesh'})}, "
                             f"got {spatial!r}")


def check_partition(step_name: str, partition, zero: Optional[Dict]) -> None:
    """A multi-rank step needs a state made with the mesh, at the stage ``zero`` names."""
    if partition is None:
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(f"{step_name}: the world has several ranks; make the state with mesh=create_mesh(...)")
        if zero is not None and zero["stage"]:
            raise ValueError(f"{step_name}(zero={zero}) needs a state made with a mesh and that stage")
    elif zero is not None and zero["stage"] != partition.stage:
        raise ValueError(f"{step_name}(zero={zero}) but the state was made at ZeRO stage {partition.stage}")


def prepare_batch(batch, step: int, generator_type: str, augment: Optional[Dict], augment_seed: int,
                  store: Optional[Dict[str, torch.Tensor]], mesh=None) -> Dict[str, torch.Tensor]:
    """The JAX step's first lines (``climsr_tpu/training/tasks/pretrain.py:102-109``):
    gather the index batch from ``store``, then augment and assemble with
    draws from ``(augment_seed, step)`` on the batch's device. With a
    ``mesh``, ``batch`` is the global batch and the rank keeps its slice of
    the data axis; the draws are made for the global batch and sliced."""
    if store is not None:
        where = next(iter(store.values())).device
        indices = torch.as_tensor(batch, dtype=torch.int64)
        n = indices.shape[0]
        local = process_local_slice(n, mesh) if mesh is not None else slice(0, n)
        batch = gather(store, indices[local].to(where))
    else:
        n = batch[B.hr].shape[0]
        local = process_local_slice(n, mesh) if mesh is not None else slice(0, n)
        if mesh is not None:
            batch = {k: v[local] for k, v in batch.items()}
    if augment is not None:
        flip = {k: augment[k] for k in ("v_flip", "h_flip", "random_90_rotation") if k in augment}
        flags = draw_flags(n, step_generator(augment_seed, step, batch[B.hr].device), **flip)
        batch = augment_and_assemble(batch, None, generator_type, flags=tuple(f[local] for f in flags), **augment)
    return batch


def spatial_forward(model: nn.Module, generator_type: str, spatial: Dict):
    """``(batch, compute_dtype) -> (sr rows, hr rows)`` through the H-sharded forward."""
    from climsr_tpu_torch.parallel.halo import spatial_sharded_model_forward

    fwd = spatial_sharded_model_forward(model, generator_type, **spatial)

    def run(batch: Dict[str, torch.Tensor], compute_dtype: torch.dtype):
        dev = next(model.parameters()).device

        def get(key):
            if key not in batch:
                return None
            return batch[key].to(device=dev, dtype=compute_dtype).contiguous(memory_format=torch.channels_last)

        sr, rows = fwd(get(B.lr), get(B.elevation), get(B.mask))
        return sr, batch[B.hr][:, :, rows]

    return run


def share_of_mean(per_element: torch.Tensor, partition, frame_rows: int) -> torch.Tensor:
    """The rank's share of the global mean of ``per_element`` (its sum over
    the global count): the batch is split over the data axis, and under
    spatial sharding the rows of ``frame_rows`` over the spatial axis."""
    count = per_element.shape[0] * partition.size * per_element.shape[1] * frame_rows * per_element.shape[3]
    return per_element.sum() / count


def reduced(value: torch.Tensor, partition, group=None) -> torch.Tensor:
    """A loss share summed over ``group`` (the world by default; for the
    metrics, no gradient)."""
    if partition is None:
        return value.detach()
    out = value.detach().clone()
    dist.all_reduce(out, group=group)
    return out


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
    return _pretrain_step(model, generator_type, compute_dtype, augment, augment_seed, store, zero, spatial, device,
                          lambda part: check_partition("make_pretrain_step", part, zero))


def _local_pretrain_step(model: nn.Module, generator_type: str, compute_dtype: torch.dtype, device: DeviceLike):
    """The batch probe's throwaway step: a state made without a mesh, run on
    this rank alone in a world of several ranks (``make_pretrain_step``
    refuses such a state there)."""
    return _pretrain_step(model, generator_type, compute_dtype, None, 0, None, None, None, device, lambda part: None)


def _pretrain_step(model, generator_type, compute_dtype, augment, augment_seed, store, zero, spatial, device,
                   check: Callable) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """:func:`make_pretrain_step`'s step, ``check(partition)`` at each call."""
    check_parallel_options("make_pretrain_step", zero, spatial)
    check_device(model, device)
    loss_fn = pixel_loss_fn(generator_type)
    squared = generator_type == consts.models.srcnn
    sharded_fwd = spatial_forward(model, generator_type, spatial) if spatial is not None else None

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        part = state.partition
        check(part)
        with span("climsr.step.prepare_batch"):
            batch = prepare_batch(batch, state.step, generator_type, augment, augment_seed, store,
                                  mesh=None if part is None else part.mesh)
        with span("climsr.step.forward"):
            state.optimizer.zero_grad()
            with nullcontext() if part is None else part.gathered():
                if sharded_fwd is not None:
                    sr, hr = sharded_fwd(batch, compute_dtype)
                else:
                    sr = apply_generator_batch(generator_type, state.model, batch, compute_dtype)
                    hr = batch[B.hr]
            hr = hr.to(device=sr.device, dtype=torch.float32)
            if part is None:
                loss = loss_fn(sr.float(), hr)
            else:
                diff = sr.float() - hr
                loss = share_of_mean(torch.square(diff) if squared else torch.abs(diff), part,
                                     batch[B.hr].shape[2])
        with span("climsr.step.backward"):
            loss.backward()
        with span("climsr.step.grad_norm"):
            if part is None:
                grad_norm = global_norm(p.grad for p in state.optimizer.params)
            else:
                part.reduce_gradients()
                grad_norm = part.grad_norm()
        with span("climsr.step.optimizer"):
            state.optimizer.step()
            if part is not None:
                part.publish()
        state.step += 1
        return state, {"train/loss": reduced(loss, part), "grad_norm": grad_norm}

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
    means ``cuda``) is where the model must be. Across ranks every rank
    passes the whole batch; each runs the generator on its share of the
    samples and the outputs are all-gathered
    (:func:`~climsr_tpu_torch.parallel.mesh.shard_samples`), so every rank
    takes the metrics of the whole batch."""
    check_device(model, device)
    loss_fn = pixel_loss_fn(generator_type)

    def generate(batch: Dict) -> torch.Tensor:
        return apply_generator_batch(generator_type, model, batch, compute_dtype).float()

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        sr = shard_samples(generate, batch)

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
