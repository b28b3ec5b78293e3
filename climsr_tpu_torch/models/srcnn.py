# -*- coding: utf-8 -*-
"""SRCNN — 3-layer 9-1-5 CNN on pre-upscaled input.

The counterpart of ``climsr_tpu.models.srcnn.SRCNN`` (reference
``climsr/models/srcnn.py``): conv9 -> 64, conv1 -> 32, conv5 -> out, ReLU
between, no internal upsampling. Also the elevation/mask fusion head inside
ESRGAN.

``fusion_dx_c0`` (the JAX module's ``pallas_bwd``): conv1 goes through
:func:`climsr_tpu_torch.ops.head_bwd.fusion_conv1`, whose input gradient is
kernel C for channel 0 and zero for channels 1+. That is exact only where
channels 1+ are data (the fusion head of a one-channel generator); ESRGAN sets
it only then. The forward and the parameters are the same either way.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from climsr_tpu_torch.models.common import TorchConv, init_torch_default_
from climsr_tpu_torch.ops.head_bwd import fusion_conv1


class SRCNN(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        generator: Optional[torch.Generator] = None,
        fusion_dx_c0: bool = False,
    ):
        super().__init__()
        self.fusion_dx_c0 = fusion_dx_c0
        self.conv1 = TorchConv(in_channels, 64, kernel_size=9, padding=4)
        self.conv2 = TorchConv(64, 32, kernel_size=1, padding=0)
        self.conv3 = TorchConv(32, out_channels, kernel_size=5, padding=2)
        if generator is not None:
            init_torch_default_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fusion_dx_c0:
            out = F.relu(fusion_conv1(x, self.conv1.weight, self.conv1.bias))
        else:
            out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        return self.conv3(out)
