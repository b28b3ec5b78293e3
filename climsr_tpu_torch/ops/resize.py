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
- :func:`resize_cubic`: host-side numpy resize of an (H, W) or (H, W, C)
  float array reproducing ``cv2.resize(..., interpolation=INTER_CUBIC)``:
  Keys' cubic with a = -0.75, half-pixel centres
  (``src = (dst + 0.5) * src_len / dst_len - 0.5``), edge pixels repeated.
  It runs the rows pass, then the columns pass, in float32, as cv2 does for a
  float32 image; the sums go in another order, so results agree with cv2's to
  float32 rounding (``tests/test_torch_data.py`` states the tolerance).
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


_CUBIC_A = -0.75


def _cv2_cubic_taps(dst_len: int, src_len: int):
    """(indices, weights), each (dst_len, 4): cv2's four source taps and their weights."""
    scale = src_len / dst_len
    f = (np.arange(dst_len, dtype=np.float64) + 0.5) * scale - 0.5
    start = np.floor(f).astype(np.int64)
    t = (f - start).astype(np.float32)
    a = np.float32(_CUBIC_A)
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1 - w0 - w1 - w2
    idx = np.clip(start[:, None] + np.arange(-1, 3)[None, :], 0, src_len - 1)
    return idx, np.stack([w0, w1, w2, w3], axis=1).astype(np.float32)


def resize_cubic(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(arr, (width, height), interpolation=cv2.INTER_CUBIC)`` in
    numpy for float arrays: (H, W) or (H, W, C) in, float32 out."""
    img = np.asarray(arr, np.float32)
    rows, wr = _cv2_cubic_taps(height, img.shape[0])
    cols, wc = _cv2_cubic_taps(width, img.shape[1])
    extra = (None,) * (img.ndim - 2)
    # columns first (cv2's horizontal pass), then rows
    tmp = sum(img[:, cols[:, k]] * wc[(None, slice(None), k) + extra] for k in range(4))
    out = sum(tmp[rows[:, k]] * wr[(slice(None), k, None) + extra] for k in range(4))
    return np.ascontiguousarray(out, dtype=np.float32)
