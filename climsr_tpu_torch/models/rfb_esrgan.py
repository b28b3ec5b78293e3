# -*- coding: utf-8 -*-
"""RFB-ESRGAN — generator with receptive-field blocks, and its VGG-style discriminator.

The counterpart of ``climsr_tpu.models.rfb_esrgan`` (reference
``climsr/models/rfb_esrgan.py``):

- ``ReceptiveFieldBlock``: a 1x1 shortcut and 4 inception branches (1x1,
  (1,3), (3,1), dilation 3 and 5), a 1x1 merge, ``out*0.2 + shortcut``,
  optional LeakyReLU; bias-free, kaiming-normal x0.1 init,
- ``ReceptiveFieldDenseBlock`` (5 RFBs, dense concat) and its residual wrapper,
- the bias-free kaiming x0.1 ``RFBResidualDenseBlock`` and its RRDB,
- generator: conv1 -> 16 RRDB (Trunk_A) -> 8 RRFDB (Trunk_RFB) -> skip add ->
  RFB -> [nearest x2, RFB, conv 256, LeakyReLU, pixel-shuffle 2, RFB] per
  factor 4 -> conv3 + LeakyReLU -> conv4 + tanh. Single input, no fusion head.
  ``scaling_factor`` must be a power of 4,
- ``RFBESRGANDiscriminator``: strided VGG features (bias-free convs,
  BatchNorm, LeakyReLU 0.2), adaptive average pool to 14x14 whatever the
  input size, FC(512*14*14 -> 1024 -> 1) and a sigmoid. The sigmoid output
  is a reference quirk the GAN task keeps: it pairs it with
  BCE-with-logits. The pooled map is flattened in NCHW order, as torch's
  ``Linear`` weights expect.

No TPU kernel runs here. The RRDB trunk's dense blocks are bias-free and the
JAX generator runs them through plain convs, not the Pallas trunk; so the
port runs them through library convs too (kernels A, B1, B2 take a bias per
conv). ``remat`` is not ported (the registry drops it).

``state_dict`` keys are the reference's (``climsr_tpu/interop/torch_import.py:178-226``):
``conv1``, ``Trunk_A.{i}.RDB{j}.conv{1..4}.0`` and ``.conv5``,
``Trunk_RFB.{i}.RFDB{j}.RFB{m}.{shortcut,branch{1..4}.{2k},conv1x1}``,
``RFB``, ``upsampling.{6b+1,6b+2,6b+5}``, ``conv3.0``, ``conv4.0``; the
discriminator's ``features.{0,3i-1,3i}`` and ``fc.{0,2}``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from climsr_tpu_torch.models.common import (
    TorchBatchNorm,
    TorchConv,
    TorchDense,
    adaptive_avg_pool,
    init_torch_default_,
    kaiming_scaled_init_,
    leaky_relu,
)


def _conv(cin: int, cout: int, kernel_size=3, padding=None, dilation: int = 1) -> TorchConv:
    return TorchConv(cin, cout, kernel_size, padding=padding, bias=False, dilation=dilation)


class ReceptiveFieldBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, scale_ratio: float = 0.2, non_linearity: bool = True):
        super().__init__()
        c = in_channels // 4
        self.scale_ratio = scale_ratio
        self.non_linearity = non_linearity
        self.shortcut = _conv(in_channels, out_channels, 1, padding=0)
        self.branch1 = nn.Sequential(_conv(in_channels, c, 1, padding=0), nn.ReLU(), _conv(c, c, 3))
        self.branch2 = nn.Sequential(
            _conv(in_channels, c, 1, padding=0), nn.ReLU(), _conv(c, c, (1, 3), padding=(0, 1)), nn.ReLU(),
            _conv(c, c, 3, dilation=3))
        self.branch3 = nn.Sequential(
            _conv(in_channels, c, 1, padding=0), nn.ReLU(), _conv(c, c, (3, 1), padding=(1, 0)), nn.ReLU(),
            _conv(c, c, 3, dilation=3))
        self.branch4 = nn.Sequential(
            _conv(in_channels, c // 2, 1, padding=0), nn.ReLU(),
            _conv(c // 2, (c // 4) * 3, (1, 3), padding=(0, 1)), nn.ReLU(),
            _conv((c // 4) * 3, c, (1, 3), padding=(0, 1)), nn.ReLU(),
            _conv(c, c, 3, dilation=5))
        self.conv1x1 = _conv(4 * c, out_channels, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)], dim=1)
        out = self.conv1x1(out) * self.scale_ratio + self.shortcut(x)
        return leaky_relu(out) if self.non_linearity else out


class ReceptiveFieldDenseBlock(nn.Module):
    def __init__(self, in_channels: int = 64, growth_channels: int = 32, scale_ratio: float = 0.2):
        super().__init__()
        ic, gc = in_channels, growth_channels
        self.scale_ratio = scale_ratio
        for m in range(1, 5):
            setattr(self, f"RFB{m}", ReceptiveFieldBlock(ic + (m - 1) * gc, gc, scale_ratio))
        self.RFB5 = ReceptiveFieldBlock(ic + 4 * gc, ic, scale_ratio, non_linearity=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for m in range(1, 5):
            feats.append(getattr(self, f"RFB{m}")(torch.cat(feats, dim=1)))
        return self.RFB5(torch.cat(feats, dim=1)) * self.scale_ratio + x


class ResidualOfReceptiveFieldDenseBlock(nn.Module):
    def __init__(self, in_channels: int = 64, growth_channels: int = 32, scale_ratio: float = 0.2):
        super().__init__()
        self.scale_ratio = scale_ratio
        self.RFDB1 = ReceptiveFieldDenseBlock(in_channels, growth_channels, scale_ratio)
        self.RFDB2 = ReceptiveFieldDenseBlock(in_channels, growth_channels, scale_ratio)
        self.RFDB3 = ReceptiveFieldDenseBlock(in_channels, growth_channels, scale_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RFDB3(self.RFDB2(self.RFDB1(x))) * self.scale_ratio + x


class RFBResidualDenseBlock(nn.Module):
    """The bias-free RDB: conv1..conv4 (each ``Sequential(conv, LeakyReLU)``) and conv5."""

    def __init__(self, in_channels: int = 64, growth_channels: int = 32, scale_ratio: float = 0.2):
        super().__init__()
        ic, gc = in_channels, growth_channels
        self.scale_ratio = scale_ratio
        for k in range(1, 5):
            setattr(self, f"conv{k}", nn.Sequential(_conv(ic + (k - 1) * gc, gc), nn.LeakyReLU(0.2)))
        self.conv5 = _conv(ic + 4 * gc, ic)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(getattr(self, f"conv{k}")(torch.cat(feats, dim=1)))
        return self.conv5(torch.cat(feats, dim=1)) * self.scale_ratio + x


class RFBResidualInResidualDenseBlock(nn.Module):
    def __init__(self, in_channels: int = 64, growth_channels: int = 32, scale_ratio: float = 0.2):
        super().__init__()
        self.scale_ratio = scale_ratio
        self.RDB1 = RFBResidualDenseBlock(in_channels, growth_channels, scale_ratio)
        self.RDB2 = RFBResidualDenseBlock(in_channels, growth_channels, scale_ratio)
        self.RDB3 = RFBResidualDenseBlock(in_channels, growth_channels, scale_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * self.scale_ratio + x


class RFBESRGANGenerator(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 1,
        scaling_factor: int = 4,
        num_rrdb_blocks: int = 16,
        num_rrfdb_blocks: int = 8,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        # each upsampling block is x4; int(log(2, 4)) == 0 would return an LR-sized output
        n_up = int(round(math.log(scaling_factor, 4)))
        if 4 ** n_up != scaling_factor:
            raise NotImplementedError(
                f"RFB-ESRGAN upsamples in x4 blocks; scaling_factor={scaling_factor} unsupported")
        self.conv1 = _conv(in_channels, 64)
        self.Trunk_A = nn.Sequential(*(RFBResidualInResidualDenseBlock(64, 32, 0.2) for _ in range(num_rrdb_blocks)))
        self.Trunk_RFB = nn.Sequential(
            *(ResidualOfReceptiveFieldDenseBlock(64, 32, 0.2) for _ in range(num_rrfdb_blocks)))
        self.RFB = ReceptiveFieldBlock(64, 64, non_linearity=False)
        layers = []
        for _ in range(n_up):
            layers += [nn.Upsample(scale_factor=2, mode="nearest"), ReceptiveFieldBlock(64, 64), _conv(64, 256),
                       nn.LeakyReLU(0.2), nn.PixelShuffle(2), ReceptiveFieldBlock(64, 64)]
        self.upsampling = nn.Sequential(*layers)
        self.conv3 = nn.Sequential(_conv(64, 64), nn.LeakyReLU(0.2))
        self.conv4 = nn.Sequential(_conv(64, out_channels), nn.Tanh())
        if generator is not None:
            init_torch_default_(self, generator)
            for m in self.modules():
                if isinstance(m, (ReceptiveFieldBlock, RFBResidualDenseBlock)):
                    kaiming_scaled_init_(m, generator, 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, h, w) -> (N, out_channels, h*s, w*s), in (-1, 1)."""
        out1 = self.conv1(x)
        out = self.RFB(out1 + self.Trunk_RFB(self.Trunk_A(out1)))
        return self.conv4(self.conv3(self.upsampling(out)))


class RFBESRGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [_conv(in_channels, 64), nn.LeakyReLU(0.2)]
        cin = 64
        for cout, stride in ((64, 2), (128, 1), (128, 2), (256, 1), (256, 2), (512, 1), (512, 2)):
            layers += [TorchConv(cin, cout, 3, bias=False, stride=stride), TorchBatchNorm(cout), nn.LeakyReLU(0.2)]
            cin = cout
        self.features = nn.Sequential(*layers)
        self.fc = nn.Sequential(TorchDense(512 * 14 * 14, 1024), nn.LeakyReLU(0.2), TorchDense(1024, 1))
        if generator is not None:
            init_torch_default_(self, generator)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The output before the sigmoid."""
        out = adaptive_avg_pool(self.features(x), (14, 14))
        return self.fc(out.reshape(out.shape[0], -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, H, W), any H, W that survive four stride-2 convs -> (N, 1) in (0, 1)."""
        return torch.sigmoid(self.logits(x))
