# -*- coding: utf-8 -*-
"""Quality metrics as torch functions + the reference's 16-metric suite (the port of ``climsr_tpu.metrics``)."""
from climsr_tpu_torch.metrics.functional import (  # noqa: F401
    mae,
    mape,
    mse,
    psnr,
    r2_score,
    regression_accuracy,
    rmse,
    smape,
    ssim,
)
from climsr_tpu_torch.metrics.suite import REGRESSION_ACCURACY_THRESHOLDS, compute_metric_suite  # noqa: F401
