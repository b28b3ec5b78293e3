# -*- coding: utf-8 -*-
"""Stateful RegressionAccuracy accumulator (torchmetrics-Metric-style API): the
port of ``climsr_tpu.metrics.regression_accuracy`` (reference
``climsr/metrics/regression_accuracy.py``). Sum states ``correct``/``total``
accumulate across updates, in float32 (a whole-globe sweep passes 2^31
pixels, where an int32 count would wrap). The suite uses the functional
form; this class is for users of the reference's object API.
"""
from __future__ import annotations

import torch


class RegressionAccuracy:
    def __init__(self, eps: float = 1.0):
        self.eps = eps
        self.reset()

    def reset(self) -> None:
        self.correct = torch.zeros((), dtype=torch.float32)
        self.total = torch.zeros((), dtype=torch.float32)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if preds.shape != target.shape:
            raise ValueError(f"preds {tuple(preds.shape)} and target {tuple(target.shape)} differ in shape")
        hits = torch.sum(torch.abs(preds - target) <= self.eps).float()
        self.correct = self.correct.to(hits.device) + hits
        self.total = self.total.to(hits.device) + float(target.numel())

    def compute(self) -> torch.Tensor:
        return self.correct / self.total

    def __call__(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        self.update(preds, target)
        return torch.mean((torch.abs(preds - target) <= self.eps).float())
