# -*- coding: utf-8 -*-
"""VGG19 perceptual loss for single-channel rasters: the port of
``climsr_tpu.losses.perceptual`` (reference ``climsr/losses/perceptual.py``).

- the grayscale input is repeated to 3 channels (``perceptual.py:26-30``),
- the loss is the L1 distance of the truncated-VGG19 features, in float32,
- the whole forward runs under ``torch.no_grad()`` (the reference's
  ``perceptual.py:23``), so the term is a logged constant that gives the
  generator no gradient, unless ``differentiable=True`` (task config
  ``differentiable_perceptual``).

Without pretrained weights on disk the features are the seeded stand-in of
:mod:`climsr_tpu_torch.models.vgg`; under the default no-grad term that
changes only the logged value.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch

from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.models.vgg import VGG19Features, load_feature_weights

logger = logging.getLogger(__name__)


def build_perceptual_loss(
    differentiable: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    cutoff: str = "conv5_4",
    device: DeviceLike = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``perceptual_fn(sr, hr) -> scalar`` (NCHW one-channel inputs, f32 result).

    The VGG parameters are float32 constants on ``device`` (``None`` means
    ``cuda``), never trained; the features compute in ``compute_dtype``.
    ``state_dict`` (``features.{i}.weight`` / ``.bias`` through ``cutoff``)
    defaults to :func:`~climsr_tpu_torch.models.vgg.load_feature_weights`.
    """
    dev = resolve_device(device)
    if state_dict is None:
        state_dict, provenance = load_feature_weights(cutoff)
        if provenance == "seeded":
            (logger.warning if differentiable else logger.info)(
                "perceptual loss on the seeded VGG19 stand-in (no weights/vgg19_features.npz or torch hub "
                "vgg19-*.pth found)%s",
                "; differentiable_perceptual=true backpropagates through it, so training differs from a "
                "pretrained run" if differentiable else "; under the no-grad term only the logged value differs",
            )
    model = VGG19Features(cutoff)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device=dev, memory_format=torch.channels_last).eval().requires_grad_(False)

    def features(x: torch.Tensor) -> torch.Tensor:
        x3 = x.repeat(1, 3, 1, 1).to(device=dev, dtype=compute_dtype).contiguous(memory_format=torch.channels_last)
        return model(x3).float()

    def perceptual_fn(fake_high_resolution: torch.Tensor, high_resolution: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
            # reference argument order: l1(net(high_resolution), net(fake))
            return torch.mean(torch.abs(features(high_resolution) - features(fake_high_resolution)))

    return perceptual_fn
