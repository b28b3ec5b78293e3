# -*- coding: utf-8 -*-
"""The reference's 16-metric validation suite with its normalized/denormalized
routing: the port of ``climsr_tpu.metrics.suite`` (reference
``climsr/core/task.py:302-380``):

- ``ssim`` and ``mape`` on the *normalized* tensors,
- ``r2`` on the *flattened denormalized* tensors,
- everything else (psnr, mae, mse, rmse, smape, acc@eps) on *denormalized*,
- accuracy thresholds {0.1, 0.25, 0.5, 0.75, 1, 1.25, 1.5, 2},
- key ``acc@01.25`` keeps the reference's label verbatim, so logged metric
  names stay interchangeable.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.metrics import functional as F

REGRESSION_ACCURACY_THRESHOLDS = (0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0)

# Reference label quirk: eps=1.25 is logged as "acc@01.25" (task.py:325).
_ACC_LABELS = ("acc@0.1", "acc@0.25", "acc@0.5", "acc@0.75", "acc@1", "acc@01.25", "acc@1.5", "acc@2")


def compute_metric_suite(
    normalized_sr: torch.Tensor,
    normalized_hr: torch.Tensor,
    denormalized_sr: torch.Tensor,
    denormalized_hr: torch.Tensor,
    mode: Optional[str] = consts.stages.val,
) -> Dict[str, torch.Tensor]:
    normalized_hr = normalized_hr.to(normalized_sr.dtype)
    denormalized_hr = denormalized_hr.to(denormalized_sr.dtype)

    results: Dict[str, torch.Tensor] = {}
    for label, eps in zip(_ACC_LABELS, REGRESSION_ACCURACY_THRESHOLDS):
        results[f"{mode}/{label}"] = F.regression_accuracy(denormalized_sr, denormalized_hr, eps=eps)
    results[f"{mode}/psnr"] = F.psnr(denormalized_sr, denormalized_hr)
    results[f"{mode}/ssim"] = F.ssim(normalized_sr, normalized_hr)
    results[f"{mode}/mae"] = F.mae(denormalized_sr, denormalized_hr)
    results[f"{mode}/mse"] = F.mse(denormalized_sr, denormalized_hr)
    results[f"{mode}/rmse"] = F.rmse(denormalized_sr, denormalized_hr)
    results[f"{mode}/mape"] = F.mape(normalized_sr, normalized_hr)
    results[f"{mode}/smape"] = F.smape(denormalized_sr, denormalized_hr)
    results[f"{mode}/r2"] = F.r2_score(denormalized_sr, denormalized_hr)
    return results
