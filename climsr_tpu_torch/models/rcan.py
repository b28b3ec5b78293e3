# -*- coding: utf-8 -*-
"""RCAN — Residual Channel Attention Network with the elev/mask fusion SRCNN head.

The counterpart of ``climsr_tpu.models.rcan`` (reference ``climsr/models/rcan.py``):

- ``CALayer``: squeeze-excite channel attention (global pool -> 1x1 reduce ->
  ReLU -> 1x1 expand -> sigmoid -> scale); the pool's mean is taken in
  float32 and rounded once (:func:`~climsr_tpu_torch.models.common.global_avg_pool`),
- ``RCAB``: conv-ReLU-conv + CA, residual,
- ``ResidualGroup``: n_resblocks RCABs + conv, residual,
- net: head conv -> n_resgroups groups + conv, global residual -> pixel-shuffle
  upsampler -> out conv -> fusion ``SRCNN(concat(x, elev, mask))``.

No TPU kernel runs here: every conv is a library conv, as in the JAX package,
and the fusion head's SRCNN computes its own input gradient (the JAX RCAN
does not set ``pallas_bwd``). The JAX module's ``spatial_axis`` /
``spatial_halo`` / ``spatial_pad`` (the H-sharded forward) belong to the
multi-GPU item of ``ROADMAP.md`` and ``remat`` is not ported: the registry
drops both.

``state_dict`` keys are the reference's (``climsr_tpu/interop/torch_import.py:116-145``):
``head.0``, ``body.{g}.body.{b}.body.{0,2,3.conv_du.0,3.conv_du.2}``,
``body.{g}.body.{n_resblocks}``, ``body.{n_resgroups}``, ``tail.0.{2k}``,
``tail.1``, ``srcnn.*``. The ``nn.Sequential`` s hold the reference's
activation modules at the odd indices so the indices match.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchConv, global_avg_pool, init_torch_default_
from climsr_tpu_torch.models.srcnn import SRCNN


class CALayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(
            TorchConv(channel, channel // reduction, 1, padding=0), nn.ReLU(),
            TorchConv(channel // reduction, channel, 1, padding=0), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(global_avg_pool(x))


class RCAB(nn.Module):
    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16):
        super().__init__()
        self.body = nn.Sequential(
            TorchConv(n_feat, n_feat, kernel_size), nn.ReLU(), TorchConv(n_feat, n_feat, kernel_size),
            CALayer(n_feat, reduction),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class ResidualGroup(nn.Module):
    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16, n_resblocks: int = 20):
        super().__init__()
        self.body = nn.Sequential(
            *(RCAB(n_feat, kernel_size, reduction) for _ in range(n_resblocks)),
            TorchConv(n_feat, n_feat, kernel_size),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class Upsampler(nn.Sequential):
    """Pixel-shuffle upsampler for power-of-two scales and 3 (convs at even indices)."""

    def __init__(self, scale: int, n_feat: int):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(scale.bit_length() - 1):
                layers += [TorchConv(n_feat, 4 * n_feat, 3), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [TorchConv(n_feat, 9 * n_feat, 3), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(f"Unsupported scale {scale}")
        super().__init__(*layers)


class RCAN(nn.Module):
    def __init__(
        self,
        n_resgroups: int = 10,
        n_resblocks: int = 20,
        n_feats: int = 64,
        reduction: int = 16,
        scaling_factor: int = 4,
        in_channels: int = 3,
        out_channels: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.head = nn.Sequential(TorchConv(in_channels, n_feats, 3))
        self.body = nn.Sequential(
            *(ResidualGroup(n_feats, 3, reduction, n_resblocks) for _ in range(n_resgroups)),
            TorchConv(n_feats, n_feats, 3),
        )
        self.tail = nn.Sequential(Upsampler(scaling_factor, n_feats), TorchConv(n_feats, out_channels, 3))
        self.srcnn = SRCNN(in_channels=3, out_channels=out_channels)
        if generator is not None:
            init_torch_default_(self, generator)

    def forward(self, x: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, h, w); elev, mask: (N, 1, h*s, w*s); returns (N, out_channels, h*s, w*s)."""
        x = self.head(x)
        x = self.tail(self.body(x) + x)
        return self.srcnn(torch.cat([x, elev.to(x.dtype), mask.to(x.dtype)], dim=1))
