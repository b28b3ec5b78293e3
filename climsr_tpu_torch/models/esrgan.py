# -*- coding: utf-8 -*-
"""ESRGAN generator — RRDB trunk + nearest-upsample head + elev/mask fusion SRCNN.

The counterpart of ``climsr_tpu.models.esrgan`` (reference
``climsr/models/esrgan.py``):

- ``ResidualDenseBlock`` (5 convs, growth gc, LeakyReLU 0.2, out*0.2 + x) runs
  as one call of :func:`climsr_tpu_torch.ops.rdb.fused_rdb`: kernel A for a
  tensor on the card at every H and W, the plain version on the CPU, and,
  where autograd needs the block's gradient, :class:`~climsr_tpu_torch.ops.rdb.FusedRDB`
  (kernels B1 and B2 on the card),
- ``ResidualInResidualDenseBlock`` = 3 RDBs, out*0.2 + x; the third RDB folds
  that outer residual into the kernel's single write (``x0``),
- generator: conv_first -> nb RRDBs -> trunk_conv + global skip ->
  [nearest x2 upsample + conv + lrelu] x2 (scale 4; with ``fused_upsample``,
  the default, in the phase form of ``ops/fused_upsample_conv.py``, which
  builds no nearest-x2 tensor) -> HRconv -> conv_last ->
  fusion head ``SRCNN(concat(out, elev_hr, mask_hr))``, whose conv1 input
  gradient is kernel C when there is one output channel (the JAX model turns
  it on under ``use_pallas`` alone, ``climsr_tpu/models/esrgan.py:289-292``,
  which is wrong for channels 1..out-1 when out_channels > 1).

Every conv computes in its input's dtype with its parameters rounded to it at
use, so a model with float32 parameters trains under bf16 compute (the input
sets the compute dtype) and a model cast to bf16 for inference computes the
same numbers.

Modules take and return NCHW tensors; the trunk runs in
``torch.channels_last`` so cuDNN's convs and the RDB kernel share NHWC storage
with no transpose between launches. ``state_dict`` keys are the reference
checkpoint keys (``RRDB_trunk.{i}.RDB{j}.conv{k}``, ...).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchConv, init_torch_default_, leaky_relu
from climsr_tpu_torch.models.srcnn import SRCNN
from climsr_tpu_torch.ops.fused_upsample_conv import nearest_up2_conv3, nearest_up2_conv3_plain
from climsr_tpu_torch.ops.rdb import PackedWeights, fused_rdb, pack_rdb_weights


class ResidualDenseBlock(nn.Module):
    """One RDB. ``concat_free`` is accepted for config parity and changes no number."""

    def __init__(self, nf: int = 64, gc: int = 32, concat_free: bool = False):
        super().__init__()
        for k in range(4):
            setattr(self, f"conv{k + 1}", TorchConv(nf + k * gc, gc))
        self.conv5 = TorchConv(nf + 4 * gc, nf)
        self._packed: Optional[Tuple[tuple, PackedWeights]] = None

    def weights(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(c.weight, c.bias) for c in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5)]

    def packed_weights(self, dtype: torch.dtype) -> PackedWeights:
        """The kernel's weight packing for ``dtype``, made once and redone only
        when a parameter changes (new storage, in-place update, dtype or device)."""
        key = (dtype,) + tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_rdb_weights(self.weights(), dtype))
        return self._packed[1]

    def forward(self, x: torch.Tensor, outer_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        packed = self.packed_weights(x.dtype) if x.is_cuda else None
        return fused_rdb(x, self.weights(), x0=outer_residual, packed=packed)


class ResidualInResidualDenseBlock(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, concat_free: bool = False):
        super().__init__()
        self.RDB1 = ResidualDenseBlock(nf, gc, concat_free)
        self.RDB2 = ResidualDenseBlock(nf, gc, concat_free)
        self.RDB3 = ResidualDenseBlock(nf, gc, concat_free)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.RDB2(self.RDB1(x))
        return self.RDB3(out, outer_residual=x)  # x + 0.2 * RDB3(out), in one write


class ESRGANGenerator(nn.Module):
    """ESRGAN with the fusion head. ``in_channels`` counts the LR input channels
    (climate + elevation + mask = 3). ``fused_upsample`` picks the phase form
    of the upsampling convs (``True``) or interpolate-then-conv (``False``),
    as ``climsr_tpu/models/esrgan.py:243``: the same parameters and numbers up
    to float reassociation. ``concat_free`` is accepted for config parity and
    changes no number."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        nf: int = 64,
        nb: int = 23,
        gc: int = 32,
        scaling_factor: int = 4,
        fused_upsample: bool = True,
        concat_free: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if scaling_factor not in (2, 4):
            raise ValueError(f"ESRGAN upsamples by 2 or 4, got {scaling_factor}")
        self.scaling_factor = scaling_factor
        self.up_conv = nearest_up2_conv3 if fused_upsample else nearest_up2_conv3_plain
        self.conv_first = TorchConv(in_channels, nf)
        self.RRDB_trunk = nn.Sequential(*(ResidualInResidualDenseBlock(nf, gc, concat_free) for _ in range(nb)))
        self.trunk_conv = TorchConv(nf, nf)
        self.upconv1 = TorchConv(nf, nf)
        if scaling_factor == 4:
            self.upconv2 = TorchConv(nf, nf)
        self.HRconv = TorchConv(nf, nf)
        self.conv_last = TorchConv(nf, out_channels)
        self.srcnn = SRCNN(in_channels=out_channels + 2, out_channels=out_channels, fusion_dx_c0=out_channels == 1)
        if generator is not None:
            init_torch_default_(self, generator)

    def forward(self, x: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels, h, w); elev, mask: (N, 1, h*s, w*s); returns (N, out_channels, h*s, w*s)."""
        fea = self.conv_first(x).contiguous(memory_format=torch.channels_last)
        trunk = self.RRDB_trunk(fea)
        fea = fea + self.trunk_conv(trunk)
        fea = leaky_relu(self.up_conv(fea, self.upconv1.weight, self.upconv1.bias))
        if self.scaling_factor == 4:
            fea = leaky_relu(self.up_conv(fea, self.upconv2.weight, self.upconv2.bias))
        out = self.conv_last(leaky_relu(self.HRconv(fea)))
        return self.srcnn(torch.cat([out, elev.to(out.dtype), mask.to(out.dtype)], dim=1))
