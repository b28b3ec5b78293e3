# -*- coding: utf-8 -*-
"""Image/regression quality metrics as torch functions: the port of
``climsr_tpu.metrics.functional``, with the same torchmetrics semantics
(reference ``climsr/core/task.py:302-340``):

- ``psnr``: ``data_range`` defaults to ``max(target) - min(target)`` of the batch,
- ``ssim``: 11x11 gaussian window, sigma 1.5, k1=0.01, k2=0.03, mean over the
  valid windows; ``data_range`` defaults to ``max(preds.range, target.range)``,
- ``mape``/``smape``: denominator clamped at 1.17e-6,
- ``r2_score``: 1 - SS_res/SS_tot over the flattened inputs,
- ``regression_accuracy``: the fraction of pixels with ``|pred - target| <= eps``.

Tensors are NCHW; every function reduces to a 0-d float32 tensor on the
inputs' device.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

_TM_EPS = 1.17e-6  # torchmetrics MAPE/SMAPE denominator clamp

Range = Union[float, torch.Tensor, None]


def mse(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(preds - target))


def rmse(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse(preds, target))


def mae(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds - target))


def mape(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds - target) / torch.clamp(torch.abs(target), min=_TM_EPS))


def smape(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(torch.abs(preds) + torch.abs(target), min=_TM_EPS)
    return torch.mean(2.0 * torch.abs(preds - target) / denom)


def r2_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    preds, target = preds.reshape(-1), target.reshape(-1)
    ss_res = torch.sum(torch.square(target - preds))
    ss_tot = torch.sum(torch.square(target - torch.mean(target)))
    return 1.0 - ss_res / ss_tot


def regression_accuracy(preds: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    return torch.mean((torch.abs(preds - target) <= eps).float())


def psnr(preds: torch.Tensor, target: torch.Tensor, data_range: Range = None) -> torch.Tensor:
    if data_range is None:
        data_range = torch.max(target) - torch.min(target)
    return 10.0 * torch.log10(torch.square(torch.as_tensor(data_range)) / mse(preds, target))


def _gaussian_kernel1d(kernel_size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    g = torch.exp(-torch.square(coords) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_separable(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Depthwise separable gaussian filter on NCHW, valid padding."""
    c = x.shape[1]
    x = F.conv2d(x, k1d.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k1d.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Range = None,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity over NCHW batches (scalar mean over valid windows)."""
    preds, target = preds.float(), target.float()
    if preds.shape[2] < kernel_size or preds.shape[3] < kernel_size:
        raise ValueError(
            f"ssim needs images >= {kernel_size}px (got {preds.shape[2]}x{preds.shape[3]}); "
            "no valid windows would remain"
        )
    if data_range is None:
        data_range = torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))
    c1 = torch.square(torch.as_tensor(k1 * data_range))
    c2 = torch.square(torch.as_tensor(k2 * data_range))
    k1d = _gaussian_kernel1d(kernel_size, sigma, preds.device)

    mu_p = _filter2d_separable(preds, k1d)
    mu_t = _filter2d_separable(target, k1d)
    mu_pp = _filter2d_separable(preds * preds, k1d)
    mu_tt = _filter2d_separable(target * target, k1d)
    mu_pt = _filter2d_separable(preds * target, k1d)

    sigma_p = mu_pp - mu_p * mu_p
    sigma_t = mu_tt - mu_t * mu_t
    sigma_pt = mu_pt - mu_p * mu_t

    num = (2.0 * mu_p * mu_t + c1) * (2.0 * sigma_pt + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)
