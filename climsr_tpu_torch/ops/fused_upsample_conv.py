# -*- coding: utf-8 -*-
"""Nearest-2x upsample followed by a 3x3 conv, for ESRGAN's upsampling head:
the port of ``climsr_tpu.ops.fused_upsample_conv``.

``conv3x3_same(nearest_upsample(x, 2))`` sees, at output phase (a, b) in
{0, 1}^2, only a 2x2 window of *source* pixels, with weights summed from the
original kernel:

    phase a=0 rows: taps (w[0], w[1]+w[2]) at source rows (i-1, i)
    phase a=1 rows: taps (w[0]+w[1], w[2]) at source rows (i, i+1)
    (the same in the column direction)

:func:`nearest_up2_conv3` runs four 2x2 convs on the low-resolution grid and
interleaves their outputs (``out[2i+a, 2j+b] = phase[a][b][i, j]``): 16 taps
instead of 36 and no nearest-x2 intermediate. The phase kernels are sums of
the one (F, C, 3, 3) weight, so autograd carries the gradient to it and the
``state_dict`` is the plain form's. :func:`nearest_up2_conv3_plain` is that
plain form (a nearest x2 interpolate, then one 3x3 conv), ESRGAN's
``fused_upsample=False``. Both are library convs: the JAX package computes
this outside any Pallas kernel.

The JAX module's ``nearest_up2_conv3_t`` emits the TPU lane layout
(F, N*2H*2W) for its ``fused_hr_tail`` kernel; an NCHW port has no such
layout, so it has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _phase_kernels(w: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """(F, C, 3, 3) -> 2x2 grid of (F, C, 2, 2) phase kernels (row phase a, column phase b)."""
    rows = (torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2),  # a=0: (F, C, 2, 3)
            torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2))  # a=1
    return tuple(
        (torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=-1),
         torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=-1))
        for r in rows
    )


def nearest_up2_conv3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3_same(nearest_upsample(x, 2))`` in the phase form.

    x: (N, C, H, W); weight: (F, C, 3, 3) OIHW; returns (N, F, 2H, 2W) in x's
    dtype (the parameters are rounded to it at use), ``torch.channels_last``."""
    n, _, h, w = x.shape
    phases = _phase_kernels(weight.to(x.dtype))
    rows = []
    for a in (0, 1):
        # phase a=0 reads source rows (i-1, i): pad the top; a=1 reads (i, i+1): pad the bottom.
        # Each phase output is viewed as (N, H, W, F); stacking b then a gives (N, H, 2, W, 2, F)
        rows.append(torch.stack(
            [F.conv2d(F.pad(x, (1 - b, b, 1 - a, a)), phases[a][b]).permute(0, 2, 3, 1) for b in (0, 1)],
            dim=3))
    out = torch.stack(rows, dim=2).reshape(n, 2 * h, 2 * w, -1).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + bias.to(x.dtype).view(1, -1, 1, 1)
    return out


def nearest_up2_conv3_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function as a nearest x2 interpolate and one 3x3 conv
    (ESRGAN's ``fused_upsample=False``); it builds the (N, C, 2H, 2W) tensor."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return F.conv2d(up, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)
