# -*- coding: utf-8 -*-
"""Nearest-2x upsample followed by a 3x3 conv, for ESRGAN's upsampling head.

``climsr_tpu.ops.fused_upsample_conv.nearest_up2_conv3`` computes
``conv3x3_same(nearest_upsample(x, 2))`` by an exact phase decomposition on
the low-resolution grid. Here it is the plain form: a nearest x2 interpolate
and one cuDNN conv. Both forms give the same numbers up to float
reassociation; the JAX package computes it outside any Pallas kernel, and it
stays a library call here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def nearest_up2_conv3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, C, H, W); weight: (F, C, 3, 3) OIHW; returns (N, F, 2H, 2W) in
    x's dtype (the parameters are rounded to it at use)."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return F.conv2d(up, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)
