# -*- coding: utf-8 -*-
"""Relativistic average GAN losses: the port of ``climsr_tpu.losses.gan``.

Reference ``climsr/task/pl_gan.py:28-61``: relativistic scores
``d_rf = D(hr) - mean(D(sr))`` and ``d_fr = D(sr) - mean(D(hr))``, with the
reference's *swapped* labels in the generator loss (``adv_rf`` against fake
labels, ``adv_fr`` against real, ``pl_gan.py:36-37``) and the standard ones in
the discriminator loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch ``BCEWithLogitsLoss`` with mean reduction, written out as the JAX one is."""
    return -torch.mean(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def relativistic_g_loss(score_real: torch.Tensor, score_fake: torch.Tensor) -> torch.Tensor:
    d_rf = score_real - score_fake.mean()
    d_fr = score_fake - score_real.mean()
    adv_rf = bce_with_logits(d_rf, torch.zeros_like(score_real))
    adv_fr = bce_with_logits(d_fr, torch.ones_like(score_real))
    return (adv_fr + adv_rf) / 2.0


def relativistic_d_loss(score_real: torch.Tensor, score_fake: torch.Tensor) -> torch.Tensor:
    d_rf = score_real - score_fake.mean()
    d_fr = score_fake - score_real.mean()
    adv_rf = bce_with_logits(d_rf, torch.ones_like(score_real))
    adv_fr = bce_with_logits(d_fr, torch.zeros_like(score_fake))
    return (adv_fr + adv_rf) / 2.0
