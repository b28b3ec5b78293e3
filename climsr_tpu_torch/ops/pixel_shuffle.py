# -*- coding: utf-8 -*-
"""Depth-to-space (pixel shuffle) and its inverse, NCHW: the port of
``climsr_tpu.ops.pixel_shuffle``.

The JAX op is written to torch's channel order for NHWC,
``out[n, h*r + i, w*r + j, c] = in[n, h, w, c*r*r + i*r + j]``, which is
``torch.nn.functional.pixel_shuffle`` on NCHW tensors; ``pixel_unshuffle`` is
its inverse. Both keep a ``torch.channels_last`` input in that layout and
work in any dtype (bf16 included): they only move elements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C*r^2, H, W) -> (N, C, H*r, W*r)."""
    return F.pixel_shuffle(x, factor)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C, H*r, W*r) -> (N, C*r^2, H, W)."""
    return F.pixel_unshuffle(x, factor)

