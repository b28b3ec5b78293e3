# -*- coding: utf-8 -*-
"""Metric result DTOs.

A copy of ``climsr_tpu.metrics.models`` (reference
``climsr/metrics/models/{metrics_result,metrics_simple}.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class MetricsSimple:
    denormalized_mae: float
    denormalized_mse: float
    denormalized_rmse: float
    denormalized_r2: float


@dataclass
class MetricsResult:
    name: str
    mae: float
    mse: float
    rmse: float
    psnr: Optional[float] = None
    ssim: Optional[float] = None
    mape: Optional[float] = None
    smape: Optional[float] = None
    r2: Optional[float] = None
