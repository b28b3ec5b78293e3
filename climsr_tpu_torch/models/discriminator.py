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

On a card the blocks run through the hand-written kernels of
:mod:`climsr_tpu_torch.ops.d_tail`: each conv without its bias (its weight
rounded to the input's dtype as ``TorchConv`` rounds it), then
``bias_leaky_bn_pad`` (bias, LeakyReLU, BatchNorm, the strided conv's pad)
and, but in the last block, ``bias_leaky_pad`` (bias, LeakyReLU, the next
block's pad), with the chain's roundings, BatchNorm's running statistics
updated as the module updates them, and the same parameters, buffers and
``state_dict``. Each such call counts ``climsr.d.tails`` (7 a forward at 4
blocks) and runs in a span ``climsr.d.tail`` keyed ``2 * block + op`` (op 0
``bias_leaky_bn_pad``, 1 ``bias_leaky_pad``). The input's pad, the last
block's LeakyReLU, the head convs and the classifier are the modules'. On the
CPU, or where a BatchNorm has a ``process_group`` (statistics across ranks),
the ``nn.Sequential`` runs as it is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from climsr_tpu_torch.models.common import TorchBatchNorm, TorchConv, TorchDense, init_torch_default_
from climsr_tpu_torch.ops import d_tail
from climsr_tpu_torch.utils.profiling import count, span


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
        self.num_conv_block = num_conv_block
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
        fe = self.feature_extraction
        if x.device.type == "cpu" or any(getattr(m, "process_group", None) is not None for m in fe):
            return self.classification(fe(x).flatten(1))
        return self.classification(self.fused_features(x).flatten(1))

    def fused_features(self, x: torch.Tensor) -> torch.Tensor:
        """``feature_extraction(x)`` with each block's chain between its convs
        through :mod:`~climsr_tpu_torch.ops.d_tail` (their plain versions on a
        CPU tensor)."""
        fe = self.feature_extraction
        blocks = self.num_conv_block
        h = fe[0](x)
        for i in range(blocks):
            conv, act, bn, sconv, sact = (fe[7 * i + k] for k in (1, 2, 3, 5, 6))
            y = _conv_without_bias(conv, h)
            with span("climsr.d.tail", key=2 * i):
                count("climsr.d.tails")
                h = d_tail.bias_leaky_bn_pad(y, conv.bias, bn, act.negative_slope)
            if i == blocks - 1:
                h = sact(sconv(h))
                break
            y = _conv_without_bias(sconv, h)
            with span("climsr.d.tail", key=2 * i + 1):
                count("climsr.d.tails")
                h = d_tail.bias_leaky_pad(y, sconv.bias, sact.negative_slope)
        for m in fe[7 * blocks:]:
            h = m(h)
        return h


def _conv_without_bias(conv: TorchConv, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x`` without its bias, the weight rounded to x's dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation, conv.groups)
