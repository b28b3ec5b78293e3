# -*- coding: utf-8 -*-
"""Shared building blocks for the generators (NCHW, ``torch.channels_last``).

- :class:`TorchConv` is ``torch.nn.Conv2d`` with explicit symmetric padding
  ``k//2 * dilation`` per dim (the reference models' convs,
  ``climsr_tpu.models.common.TorchConv``); it takes non-square kernels, a
  per-dim padding and a dilation, as the RFB-ESRGAN branches need.
  It computes in its input's dtype and rounds its weight and bias to that
  dtype at use, as flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does,
  so float32 parameters train under bf16 compute and their gradients flow
  back through the cast; a module already cast to the input's dtype computes
  exactly as before. Its parameters start at zero; random values come only
  from :func:`init_torch_default_`, which takes an explicit ``torch.Generator``.
- :class:`TorchDense` is ``torch.nn.Linear`` with the same rounding of its
  parameters to the input's dtype at use (``climsr_tpu.models.common.TorchDense``).
- :func:`init_torch_default_` draws torch's default conv and linear init,
  U(±1/sqrt(fan_in)) for kernel and bias (kaiming-uniform with a=sqrt(5)), the
  same distribution ``climsr_tpu/models/common.py:28-44,103-125`` mirrors.
- :func:`kaiming_scaled_init_` draws RFB-ESRGAN's ``kaiming_normal_`` (fan_in,
  relu gain) times ``scale`` into the convs of a module
  (``climsr_tpu/models/common.py:44-52``), from an explicit generator too.
- :func:`global_avg_pool` and :func:`adaptive_avg_pool` are the JAX package's
  pools (``common.py:188-228``): the mean is taken in float32 and rounded
  once to the input's dtype, as ``jnp.mean`` does for bf16.
- :class:`TorchBatchNorm` is ``BatchNorm2d`` with the semantics of
  ``climsr_tpu.models.common.TorchBatchNorm`` under any compute dtype.

The JAX package's reflection padding (``climsr_tpu/models/common.py``
``reflect_pad_2d``) is torch's own ``nn.ReflectionPad2d``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


IntPair = Union[int, Tuple[int, int]]


class TorchConv(nn.Conv2d):
    """Conv2d with explicit k//2 * dilation ('same'-style) padding per dim and
    zero-initialised parameters."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: IntPair = 3,
        padding: Optional[IntPair] = None,
        bias: bool = True,
        stride: int = 1,
        dilation: int = 1,
    ):
        ks = kernel_size if isinstance(kernel_size, tuple) else (kernel_size, kernel_size)
        if padding is None:
            padding = tuple(k // 2 * dilation for k in ks)
        super().__init__(in_channels, out_channels, ks, stride=stride, padding=padding, dilation=dilation, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def reset_parameters(self) -> None:
        # no draw from the global RNG: init_torch_default_ takes a generator
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class TorchDense(nn.Linear):
    """Linear that rounds its parameters to the input's dtype at use; zero-initialised."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d as ``climsr_tpu/models/common.py:128-181`` computes it: in
    train mode normalisation by the biased batch variance and the running
    variance updated with the unbiased one, torch momentum 0.1, eps 1e-5. The
    statistics and the normalisation run in float32 on float32 parameters and
    buffers whatever the input's dtype, and the result is rounded to it (as
    the JAX module's ``stat_dtype``); ``nn.BatchNorm2d`` would take a bf16
    input only with bf16 buffers. State-dict keys are ``nn.BatchNorm2d``'s.

    ``process_group`` (set by ``GANTrainState.create`` with a mesh): in train
    mode the mean and variance are those of the global batch, summed over the
    group's ranks by differentiable all-reduces (two passes, as the
    single-process variance), the running statistics updated with them, as
    the JAX module computes on a batch sharded over the data axis."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.num_batches_tracked.add_(1)
        if not self.training or self.process_group is None:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight.float(),
                             self.bias.float(), self.training, self.momentum, self.eps)
            return y.to(x.dtype)
        from climsr_tpu_torch.parallel.mesh import all_reduce_sum

        xf = x.float()
        count = torch.tensor(float(x.numel() // x.shape[1]), device=x.device)
        count = all_reduce_sum(count, self.process_group)
        mean = all_reduce_sum(xf.sum(dim=(0, 2, 3)), self.process_group) / count
        centred = xf - mean.view(1, -1, 1, 1)
        var = all_reduce_sum(torch.square(centred).sum(dim=(0, 2, 3)), self.process_group) / count
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(m * var.detach() * count / (count - 1))
        y = centred * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        return (y * self.weight.float().view(1, -1, 1, 1) + self.bias.float().view(1, -1, 1, 1)).to(x.dtype)


@torch.no_grad()
def init_torch_default_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every conv and linear of ``module`` with torch's default init, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    return module


@torch.no_grad()
def kaiming_scaled_init_(module: nn.Module, generator: torch.Generator, scale: float = 0.1) -> nn.Module:
    """Fill every conv of ``module`` with N(0, (sqrt(2 / fan_in) * scale)^2), drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()) * scale, generator=generator)
    return module


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 1, 1), the mean in float32 rounded once to x's dtype."""
    return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch's ``AdaptiveAvgPool2d`` windows (``floor(i*H/oh)`` to
    ``ceil((i+1)*H/oh)``), which the JAX pool copies, up-pooling included
    (8x8 -> 14x14 duplicates rows); float32 sums, rounded once."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(x.float(), out_hw).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
