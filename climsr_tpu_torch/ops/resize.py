# -*- coding: utf-8 -*-
"""Nearest-neighbour resizes with cv2's index rule.

- :func:`nearest_upsample` / :func:`nearest_downsample`: integer factors over
  the last two dims of a tensor (H, W of NCHW), as
  ``climsr_tpu.ops.resize`` does over H, W of NHWC. For integer factors cv2's
  nearest is pixel repeat up and top-left decimation down.
- :func:`resize_nearest`: host-side numpy resize of an (H, W) or (H, W, C)
  array to any size, reproducing ``cv2.resize(..., interpolation=INTER_NEAREST)``
  exactly. cv2 maps destination index ``d`` to source
  ``min(floor(d * (1 / (dst_len / src_len))), src_len - 1)`` in double
  precision, i.e. ``floor(d * src_len / dst_len)`` up to that rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def nearest_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest decimation over the last two dims."""
    if factor == 1:
        return x
    return x[..., ::factor, ::factor]


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest (pixel-repeat) upsample over the last two dims."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def _cv2_nearest_index(dst_len: int, src_len: int) -> np.ndarray:
    inv_scale = 1.0 / (dst_len / src_len)
    return np.minimum(np.floor(np.arange(dst_len) * inv_scale).astype(np.int64), src_len - 1)


def resize_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(arr, (width, height), interpolation=cv2.INTER_NEAREST)`` in numpy.

    ``arr`` is (H, W) or (H, W, C); the result keeps its dtype and layout.
    """
    rows = _cv2_nearest_index(height, arr.shape[0])
    cols = _cv2_nearest_index(width, arr.shape[1])
    return np.ascontiguousarray(arr[rows[:, None], cols[None, :]])
