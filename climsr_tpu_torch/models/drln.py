# -*- coding: utf-8 -*-
"""DRLN — Densely Residual Laplacian Network (single-input generator).

The counterpart of ``climsr_tpu.models.drln`` (reference ``climsr/models/drln.py``):
20 dense-residual ``Block`` s with cascading concat wiring, per-group residual
anchors (a1..a6), pixel-shuffle upsampling, conv tail. The reference's
wiring quirks are kept, as the JAX package keeps them:

- there is no ``o4``: ``b5`` reads the anchor ``a1`` and ``c5`` concatenates
  ``[c4_cat, b5]``; the reference's compressor ``c4`` is never applied, so
  no module is made for it (a reference checkpoint's ``c4.body.*`` is
  dropped on load, :func:`~climsr_tpu_torch.interop.params.load_generator_checkpoint`);
- groups 5 and 6 have four blocks (``c16`` and ``c20`` see 5x channels);
- the channel attention is a 1x1 conv + ReLU, then a zero-padded 3x3 conv +
  sigmoid on the 1x1 pooled map.

No TPU kernel runs here: every conv is a library conv, as in the JAX package.
``remat`` is not ported (the registry drops it).

``state_dict`` keys are the reference's (``climsr_tpu/interop/torch_import.py:148-175``):
``head``, ``b{i}.r{j}.body.{0,2}``, ``b{i}.g.body.0``, ``b{i}.ca.c1.body.0``,
``b{i}.ca.c4.body.0``, ``c{i}.body.0``, ``upsample.up.body.{3k}``, ``tail``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchConv, global_avg_pool, init_torch_default_

# the blocks of each residual group; the block after 4 reads the group's anchor
GROUPS = ((1, 2, 3), (4, 5, 6), (7, 8, 9), (10, 11, 12), (13, 14, 15, 16), (17, 18, 19, 20))
NO_COMPRESSOR = 4


class BasicBlock(nn.Module):
    """conv + ReLU (``body.0``, ``body.1``)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3, pad: Optional[int] = None):
        super().__init__()
        self.body = nn.Sequential(TorchConv(in_channels, out_channels, ksize, padding=pad), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class ResidualBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.body = nn.Sequential(TorchConv(features, features, 3), nn.ReLU(), TorchConv(features, features, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.body(x) + x)


class _SigmoidConv(nn.Module):
    """Zero-padded 3x3 conv + sigmoid (``body.0``, ``body.1``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.body = nn.Sequential(TorchConv(in_channels, out_channels, 3, padding=1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class DRLNCALayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        hidden = (channel // reduction) * 3
        self.c1 = BasicBlock(channel, hidden, ksize=1, pad=0)
        self.c4 = _SigmoidConv(hidden, channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.c4(self.c1(global_avg_pool(x)))


class Block(nn.Module):
    """3 growing ResidualBlocks + 1x1 compress + CA."""

    def __init__(self, channels: int):
        super().__init__()
        self.r1 = ResidualBlock(channels)
        self.r2 = ResidualBlock(channels * 2)
        self.r3 = ResidualBlock(channels * 4)
        self.g = BasicBlock(channels * 8, channels, ksize=1, pad=0)
        self.ca = DRLNCALayer(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = torch.cat([x, self.r1(x)], dim=1)
        c2 = torch.cat([c1, self.r2(c1)], dim=1)
        c3 = torch.cat([c2, self.r3(c2)], dim=1)
        return self.ca(self.g(c3))


class _UpsampleBody(nn.Module):
    def __init__(self, n_channels: int, scale: int):
        super().__init__()
        layers = []
        if scale in (2, 4, 8):
            for _ in range(scale.bit_length() - 1):
                layers += [TorchConv(n_channels, 4 * n_channels, 3), nn.ReLU(), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [TorchConv(n_channels, 9 * n_channels, 3), nn.ReLU(), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(f"Unsupported scale {scale}")
        self.body = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class UpsampleBlock(nn.Module):
    def __init__(self, n_channels: int, scale: int):
        super().__init__()
        self.up = _UpsampleBody(n_channels, scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class DRLN(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        scaling_factor: int = 4,
        channels: int = 64,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        ch = channels
        self.head = TorchConv(in_channels, ch, 3)
        for group in GROUPS:
            for pos, i in enumerate(group, start=2):
                setattr(self, f"b{i}", Block(ch))
                if i != NO_COMPRESSOR:  # c{i} reads the group's concat: pos x ch channels
                    setattr(self, f"c{i}", BasicBlock(pos * ch, ch, ksize=3))
        self.upsample = UpsampleBlock(ch, scaling_factor)
        self.tail = TorchConv(ch, out_channels, 3)
        if generator is not None:
            init_torch_default_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, h, w) -> (N, out_channels, h*s, w*s)."""
        x = self.head(x)
        anchor, prev = x, x  # group 1 concatenates onto c0 = x
        for group in GROUPS:
            cat, inp = prev, anchor
            for i in group:
                cat = torch.cat([cat, getattr(self, f"b{i}")(inp)], dim=1)
                if i != NO_COMPRESSOR:  # no o4: the next block reads the anchor again
                    inp = getattr(self, f"c{i}")(cat)
            anchor, prev = inp + anchor, inp
        return self.tail(self.upsample(anchor + x))
