# -*- coding: utf-8 -*-
"""RCAN — Residual Channel Attention Network with the elev/mask fusion SRCNN head.

The counterpart of ``climsr_tpu.models.rcan`` (reference ``climsr/models/rcan.py``):

- ``CALayer``: squeeze-excite channel attention (global pool -> 1x1 reduce ->
  ReLU -> 1x1 expand -> sigmoid -> scale); the pool's mean is taken in
  float32 and rounded once (:func:`~climsr_tpu_torch.models.common.global_avg_pool`).
  Each call runs in a span ``climsr.rcan.ca`` keyed by the block's index in
  the net (group x n_resblocks + block) and adds one to the counter
  ``climsr.rcan.ca_calls`` (``utils/profiling.py``; off by default),
- ``RCAB``: conv-ReLU-conv + CA, residual,
- ``ResidualGroup``: n_resblocks RCABs + conv, residual,
- net: head conv -> n_resgroups groups + conv, global residual -> pixel-shuffle
  upsampler -> out conv -> fusion ``SRCNN(concat(x, elev, mask))``.

No TPU kernel runs here: every conv is a library conv, as in the JAX package,
and the fusion head's SRCNN computes its own input gradient (the JAX RCAN
does not set ``pallas_bwd``). ``remat`` is not ported: the registry drops it.

Under an H-sharded forward (``parallel/halo.py``) the channel attention's
global pool must span the whole frame, not the rank's slice.
``spatial_axis`` (the ``(group, rank, size)`` of the mesh axis, from
``parallel.mesh.axis_info``), ``spatial_halo`` and ``spatial_pad`` make it a
halo-masked local sum and count, summed over the axis by a differentiable
all-reduce; the bottom ``spatial_pad`` reflect-padded rows of the last shard
are masked too (``climsr_tpu/models/rcan.py:30-80``). :meth:`RCAN.clone`
gives a module with those values that shares this one's parameters.

``state_dict`` keys are the reference's (``climsr_tpu/interop/torch_import.py:116-145``):
``head.0``, ``body.{g}.body.{b}.body.{0,2,3.conv_du.0,3.conv_du.2}``,
``body.{g}.body.{n_resblocks}``, ``body.{n_resgroups}``, ``tail.0.{2k}``,
``tail.1``, ``srcnn.*``. The ``nn.Sequential`` s hold the reference's
activation modules at the odd indices so the indices match.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchConv, global_avg_pool, init_torch_default_
from climsr_tpu_torch.models.srcnn import SRCNN
from climsr_tpu_torch.parallel.mesh import all_reduce_sum
from climsr_tpu_torch.utils.profiling import count, span

SpatialAxis = Optional[Tuple[object, int, int]]  # (process group, rank in the axis, axis size)


class CALayer(nn.Module):
    block: Optional[int] = None  # the RCAB's index in its RCAN, the key of its span

    def __init__(self, channel: int, reduction: int = 16, spatial_axis: SpatialAxis = None,
                 spatial_halo: int = 0, spatial_pad: int = 0):
        super().__init__()
        self.spatial_axis, self.spatial_halo, self.spatial_pad = spatial_axis, spatial_halo, spatial_pad
        self.conv_du = nn.Sequential(
            TorchConv(channel, channel // reduction, 1, padding=0), nn.ReLU(),
            TorchConv(channel // reduction, channel, 1, padding=0), nn.Sigmoid(),
        )

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over H and W, in float32 rounded once to x's dtype: of the
        whole frame across the spatial axis when it is set."""
        if self.spatial_axis is None:
            return global_avg_pool(x)
        group, rank, size = self.spatial_axis
        h, halo = x.shape[2], self.spatial_halo
        rows = torch.arange(h, device=x.device)
        keep = (rows >= halo) & (rows < h - halo)  # [halo | own rows | halo] on every shard
        if self.spatial_pad and rank == size - 1:
            keep &= ~((rows >= h - halo - self.spatial_pad) & (rows < h - halo))  # phantom rows
        s = torch.sum(x.float() * keep.view(1, 1, h, 1), dim=(2, 3), keepdim=True)
        c = keep.sum().float() * x.shape[3]
        return (all_reduce_sum(s, group) / all_reduce_sum(c, group)).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("climsr.rcan.ca_calls")
        with span("climsr.rcan.ca", key=self.block):
            return x * self.conv_du(self.pool(x))


class RCAB(nn.Module):
    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16, spatial_axis: SpatialAxis = None,
                 spatial_halo: int = 0, spatial_pad: int = 0):
        super().__init__()
        self.body = nn.Sequential(
            TorchConv(n_feat, n_feat, kernel_size), nn.ReLU(), TorchConv(n_feat, n_feat, kernel_size),
            CALayer(n_feat, reduction, spatial_axis, spatial_halo, spatial_pad),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class ResidualGroup(nn.Module):
    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16, n_resblocks: int = 20,
                 spatial_axis: SpatialAxis = None, spatial_halo: int = 0, spatial_pad: int = 0):
        super().__init__()
        self.body = nn.Sequential(
            *(RCAB(n_feat, kernel_size, reduction, spatial_axis, spatial_halo, spatial_pad)
              for _ in range(n_resblocks)),
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
        spatial_axis: SpatialAxis = None,
        spatial_halo: int = 0,
        spatial_pad: int = 0,
    ):
        super().__init__()
        self.spatial_axis, self.spatial_halo, self.spatial_pad = spatial_axis, spatial_halo, spatial_pad
        self.head = nn.Sequential(TorchConv(in_channels, n_feats, 3))
        self.body = nn.Sequential(
            *(ResidualGroup(n_feats, 3, reduction, n_resblocks, spatial_axis, spatial_halo, spatial_pad)
              for _ in range(n_resgroups)),
            TorchConv(n_feats, n_feats, 3),
        )
        self.tail = nn.Sequential(Upsampler(scaling_factor, n_feats), TorchConv(n_feats, out_channels, 3))
        self.srcnn = SRCNN(in_channels=3, out_channels=out_channels)
        for i, ca in enumerate(m for m in self.modules() if isinstance(m, CALayer)):
            ca.block = i
        if generator is not None:
            init_torch_default_(self, generator)

    def clone(self, spatial_axis: SpatialAxis = None, spatial_halo: int = 0, spatial_pad: int = 0) -> "RCAN":
        """This RCAN with the channel attention's spatial values set: new
        module objects that share this one's parameters and buffers (flax's
        ``model.clone(spatial_axis=...)``)."""

        def shallow(m: nn.Module) -> nn.Module:
            c = copy.copy(m)
            c._modules = {k: shallow(v) for k, v in m._modules.items()}
            c._parameters, c._buffers = dict(m._parameters), dict(m._buffers)
            if hasattr(c, "spatial_axis"):
                c.spatial_axis, c.spatial_halo, c.spatial_pad = spatial_axis, spatial_halo, spatial_pad
            return c

        return shallow(self)

    def forward(self, x: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, h, w); elev, mask: (N, 1, h*s, w*s); returns (N, out_channels, h*s, w*s)."""
        x = self.head(x)
        x = self.tail(self.body(x) + x)
        return self.srcnn(torch.cat([x, elev.to(x.dtype), mask.to(x.dtype)], dim=1))
