# -*- coding: utf-8 -*-
"""ESRGAN discriminator: reflection-padded conv stack, logits out.

The counterpart of ``climsr_tpu.models.discriminator.Discriminator``
(reference ``climsr/models/discriminator.py``): ``num_conv_block`` blocks of
[reflect-pad, conv3, LeakyReLU(0.01), BatchNorm, reflect-pad, strided conv3,
LeakyReLU(0.01)], then two unpadded convs (LeakyReLU(0.2) between), flatten
and Linear(fan_in, 100) -> Linear(100, 1). The output is logits, for the
relativistic BCE-with-logits losses.

``state_dict`` keys are the reference's (``climsr_tpu/interop/torch_import.py:229-245``):
``feature_extraction.{7i+1, 7i+3, 7i+5}`` (conv, BatchNorm, strided conv of
block i), ``feature_extraction.{7n, 7n+2}`` (the head convs) and
``classification.{0, 1}``.

torch's Linear needs fc1's fan-in when it is built, where flax infers it from
the first input: it is taken from ``hr_size``, the HR side the discriminator
will see (8192 at 128 px with ``out_channels=64``, the reference's fixed
``Linear(8192, 100)``). An input of another size raises, naming the size
the module was built for.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchBatchNorm, TorchConv, TorchDense, init_torch_default_


def flatten_size(hr_size: int, out_channels: int = 64, num_conv_block: int = 4) -> int:
    """fc1's fan-in: the last block's channels times the head's output side."""
    side = hr_size
    for _ in range(num_conv_block):
        side = (side - 1) // 2 + 1  # reflect-pad 1, conv3 stride 2
    side -= 4  # two unpadded conv3
    if side < 1:
        raise ValueError(f"a {hr_size}-px input is too small for {num_conv_block} blocks and the head convs")
    return out_channels * 2 ** (num_conv_block - 1) * side * side


class Discriminator(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 64,
        num_conv_block: int = 4,
        hr_size: int = 128,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hr_size = hr_size
        layers = []
        cin, features = in_channels, out_channels
        for _ in range(num_conv_block):
            layers += [
                nn.ReflectionPad2d(1), TorchConv(cin, features, 3, padding=0), nn.LeakyReLU(0.01),
                TorchBatchNorm(features),
                nn.ReflectionPad2d(1), TorchConv(features, features, 3, padding=0, stride=2), nn.LeakyReLU(0.01),
            ]
            cin, features = features, features * 2
        layers += [TorchConv(cin, cin, 3, padding=0), nn.LeakyReLU(0.2), TorchConv(cin, cin, 3, padding=0)]
        self.feature_extraction = nn.Sequential(*layers)
        self.classification = nn.Sequential(
            TorchDense(flatten_size(hr_size, out_channels, num_conv_block), 100), TorchDense(100, 1))
        if generator is not None:
            init_torch_default_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, hr_size, hr_size) -> logits (N, 1), in x's dtype."""
        if tuple(x.shape[2:]) != (self.hr_size, self.hr_size):
            raise ValueError(f"the discriminator was built for {self.hr_size}x{self.hr_size} inputs (its fc1 "
                             f"fan-in); got {tuple(x.shape[2:])}")
        return self.classification(self.feature_extraction(x).flatten(1))
