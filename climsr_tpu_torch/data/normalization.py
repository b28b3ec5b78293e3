# -*- coding: utf-8 -*-
"""Min-max and z-score scalers as pure functions over numpy arrays or torch tensors.

Behaviour of ``climsr_tpu.data.normalization`` (reference
``climsr/data/normalization.py``):

- ``MinMaxScaler.normalize(arr, min, max, missing_indicator)``: optional
  missing-indicator→NaN substitution, optional per-array nanmin/nanmax,
  ``scale = (b - a) / (range + eps)``, then NaN→``nan_substitution``, float32 out.
- ``MinMaxScaler.denormalize(arr, min, max)``: exact inverse with *per-sample*
  min/max broadcast across a batch (min/max reshaped to ``(B, 1, 1, 1)``).
- ``StandardScaler``: ``(x - mean) / (std + eps)``; denormalize is
  ``x * std + mean`` — deliberately *without* eps, matching the reference
  asymmetry at ``normalization.py:115-116``.

All functions are non-mutating. A numpy array (or scalar) is handled with
numpy, a ``torch.Tensor`` with torch on its own device.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import numpy as np
import torch

minmax = "minmax"
zscore = "zscore"

Array = Union[np.ndarray, torch.Tensor]


def _torch_asarray(arr, dtype=None):
    if isinstance(arr, torch.Tensor):
        return arr if dtype is None else arr.to(dtype)
    return torch.as_tensor(arr, dtype=dtype)


def _torch_nanmax(t):
    return torch.where(torch.isnan(t), torch.full_like(t, -float("inf")), t).max()


def _torch_nanmin(t):
    return torch.where(torch.isnan(t), torch.full_like(t, float("inf")), t).min()


# the subset of numpy's namespace the scalers use, over torch tensors
_TORCH_NS = SimpleNamespace(
    asarray=_torch_asarray,
    float32=torch.float32,
    nan=float("nan"),
    where=lambda c, a, b: torch.where(c, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32)),
    isnan=torch.isnan,
    nanmax=_torch_nanmax,
    nanmin=_torch_nanmin,
)


def _xp(arr):
    """Return the array namespace (numpy or the torch adapter) for ``arr``."""
    if isinstance(arr, torch.Tensor):
        return _TORCH_NS
    return np


def _astype_f32(arr, xp):
    return arr.astype(np.float32) if xp is np else arr.to(torch.float32)


def _broadcast_per_sample(stat, arr, xp):
    """Reshape per-sample stats ``(B,)`` to broadcast over ``(B, ...)`` arrays.

    Scalars pass through unchanged.
    """
    if xp is _TORCH_NS and isinstance(arr, torch.Tensor):
        stat = torch.as_tensor(stat, dtype=torch.float32, device=arr.device)
    else:
        stat = xp.asarray(stat)
    if stat.ndim == 0:
        return stat
    return stat.reshape(tuple(stat.shape) + (1,) * (arr.ndim - stat.ndim))


def minmax_normalize(
    arr: Array,
    min: Optional[Array] = None,  # noqa: A002 — parity with reference API
    max: Optional[Array] = None,  # noqa: A002
    missing_indicator: Optional[float] = None,
    feature_range: Tuple[float, float] = (0.0, 1.0),
    eps: float = 1e-8,
    nan_substitution: float = 0.0,
) -> Array:
    xp = _xp(arr)
    a, b = feature_range
    out = xp.asarray(arr, dtype=xp.float32)
    if missing_indicator:
        out = xp.where(out == missing_indicator, xp.nan, out)
    if min is None or max is None:
        max = xp.nanmax(out)  # noqa: A001
        min = xp.nanmin(out)  # noqa: A001
    min = _broadcast_per_sample(min, out, xp)  # noqa: A001
    max = _broadcast_per_sample(max, out, xp)  # noqa: A001
    data_range = max - min
    scale = (b - a) / (data_range + eps)
    out = out * scale + (a - min * scale)
    out = xp.where(xp.isnan(out), nan_substitution, out)
    return _astype_f32(out, xp)


def minmax_denormalize(
    arr: Array,
    min: Array,  # noqa: A002
    max: Array,  # noqa: A002
    feature_range: Tuple[float, float] = (0.0, 1.0),
    eps: float = 1e-8,
) -> Array:
    xp = _xp(arr)
    a, b = feature_range
    min = _broadcast_per_sample(min, arr, xp)  # noqa: A001
    max = _broadcast_per_sample(max, arr, xp)  # noqa: A001
    data_range = max - min
    scale = (b - a) / (data_range + eps)
    min_ = a - min * scale
    return (arr - min_) / scale


def zscore_normalize(
    arr: Array,
    mean: Array,
    std: Array,
    eps: float = 1e-8,
    missing_indicator: Optional[float] = None,
    nan_substitution: Optional[float] = None,
) -> Array:
    xp = _xp(arr)
    out = xp.asarray(arr, dtype=xp.float32)
    if missing_indicator:
        out = xp.where(out == missing_indicator, xp.nan, out)
    out = (out - mean) / (std + eps)
    if nan_substitution is not None and nan_substitution:
        # Reference quirk (`StandardScaler._normalize:110`): substitution only
        # happens when the configured value is truthy (a 0.0 sub is a no-op).
        out = xp.where(xp.isnan(out), nan_substitution, out)
    return _astype_f32(out, xp)


def zscore_denormalize(arr: Array, mean: Array, std: Array) -> Array:
    # No eps here — matches the reference inverse (normalization.py:116).
    return (arr * std) + mean


@dataclasses.dataclass
class Scaler:
    """Common scaler interface; see :class:`MinMaxScaler` / :class:`StandardScaler`."""

    def normalize(self, *args, **kwargs):
        return self._normalize(*args, **kwargs)

    def denormalize(self, *args, **kwargs):
        return self._denormalize(*args, **kwargs)


@dataclasses.dataclass
class MinMaxScaler(Scaler):
    eps: float = 1e-8
    feature_range: Tuple[float, float] = (0.0, 1.0)
    nan_substitution: float = 0.0

    def _normalize(self, arr, min=None, max=None, missing_indicator=None):  # noqa: A002
        return minmax_normalize(
            arr,
            min=min,
            max=max,
            missing_indicator=missing_indicator,
            feature_range=self.feature_range,
            eps=self.eps,
            nan_substitution=self.nan_substitution,
        )

    def _denormalize(self, arr, min, max):  # noqa: A002
        return minmax_denormalize(arr, min=min, max=max, feature_range=self.feature_range, eps=self.eps)


@dataclasses.dataclass
class StandardScaler(Scaler):
    mean: float = 0.0
    std: float = 1.0
    eps: float = 1e-8
    missing_indicator: Optional[float] = None
    nan_substitution: Optional[float] = None

    def _normalize(self, arr, missing_indicator=None):
        # Per-call override, mirroring MinMaxScaler, so both modes treat
        # elevation voids (-32768) as missing instead of ~-100-sigma outliers.
        return zscore_normalize(
            arr,
            mean=self.mean,
            std=self.std,
            eps=self.eps,
            missing_indicator=self.missing_indicator if missing_indicator is None else missing_indicator,
            nan_substitution=self.nan_substitution,
        )

    def _denormalize(self, arr):
        return zscore_denormalize(arr, mean=self.mean, std=self.std)
