# -*- coding: utf-8 -*-
"""Shared building blocks for the generators (NCHW, ``torch.channels_last``).

- :class:`TorchConv` is ``torch.nn.Conv2d`` with explicit symmetric padding
  ``k//2`` (the reference models' convs, ``climsr_tpu.models.common.TorchConv``).
  It computes in its input's dtype and rounds its weight and bias to that
  dtype at use, as flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does,
  so float32 parameters train under bf16 compute and their gradients flow
  back through the cast; a module already cast to the input's dtype computes
  exactly as before. Its parameters start at zero; random values come only
  from :func:`init_torch_default_`, which takes an explicit ``torch.Generator``.
- :func:`init_torch_default_` draws torch's default conv init,
  U(±1/sqrt(fan_in)) for kernel and bias (kaiming-uniform with a=sqrt(5)), the
  same distribution ``climsr_tpu/models/common.py:28-44`` mirrors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class TorchConv(nn.Conv2d):
    """Conv2d with explicit k//2 ('same'-style) padding and zero-initialised parameters."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: Optional[int] = None,
        bias: bool = True,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size,
            padding=kernel_size // 2 if padding is None else padding, bias=bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def reset_parameters(self) -> None:
        # no draw from the global RNG: init_torch_default_ takes a generator
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


@torch.no_grad()
def init_torch_default_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every conv of ``module`` with torch's default init, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    return module


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
