# -*- coding: utf-8 -*-
"""The port's RCAN against the benchmark's plain reference
(``perfbench/reference/rcan.py``), on the CPU in float32, and the channel
attention's spans.

- seeded weights (the reference's ``seeded_params``) at 2 groups x 3 RCABs x
  16 features, reduction 4, batch 2, LR 8 load into the port with
  ``strict=True``; the forward output, the L1 loss and every leaf's gradient
  agree with the reference's, and so do the parameters after 3 AdamW steps on
  the one-cycle schedule through the port's pre-training step;
- with the recording on, a forward records one ``climsr.rcan.ca`` span an
  RCAB (keyed by its index) and the counter ``climsr.rcan.ca_calls`` reads 6;
  off, nothing is recorded and the output is bitwise the same.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from climsr_tpu_torch.config.schemas import OptimizerConfig, SchedulerConfig
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.training import schedules
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
from climsr_tpu_torch.training.train_state import TrainState
from climsr_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.reference import esrgan  # noqa: E402
from perfbench.reference import rcan as ref  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402

torch.set_num_threads(1)

GEN = dict(name="rcan", n_resgroups=2, n_resblocks=3, n_feats=16, reduction=4, in_channels=3, out_channels=1,
           scaling_factor=4)
# the one-cycle AdamW of perfbench/traffic/pretrain-b96.json, over 10 updates
OPT = dict(lr=1e-4, weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8)
ONE_CYCLE = dict(pct_start=0.05, div_factor=2.0, final_div_factor=100.0, base_momentum=0.85, max_momentum=0.95)
TOTAL = 10


def _model(seed=3):
    params = ref.seeded_params(GEN, seed, torch.device("cpu"))
    model = create_generator("rcan", dtype=torch.float32, device="cpu", train=True,
                             **{k: GEN[k] for k in ("n_resgroups", "n_resblocks", "n_feats", "reduction")})
    model.load_state_dict(params, strict=True)
    return model, params


def _batch(seed=0, n=2, h=8):
    g = torch.Generator().manual_seed(seed)
    hr = 4 * h
    return {"lr": torch.randn(n, 3, h, h, generator=g), "hr": torch.randn(n, 1, hr, hr, generator=g),
            "elevation": torch.randn(n, 1, hr, hr, generator=g),
            "mask": (torch.rand(n, 1, hr, hr, generator=g) > 0.3).float()}


def test_forward_loss_and_gradients_match_the_reference():
    """Output and loss to 1e-5 relative, each gradient to 1e-4 of its leaf's
    largest reference value: float32 throughout, so only the summation order
    differs (the port's channels_last convs against the reference's NCHW ones),
    about 1e-6 relative, carried through 6 RCABs and back."""
    model, params = _model()
    b = _batch()
    sr = model(b["lr"], b["elevation"], b["mask"])
    loss = torch.mean(torch.abs(sr - b["hr"]))
    loss.backward()
    want_loss, want_grads, want_sr = ref.loss_and_grads(params, GEN, b, block=1, conv=esrgan.f32_conv)
    np.testing.assert_allclose(sr.detach().numpy(), want_sr.numpy(), rtol=1e-5, atol=1e-5 * want_sr.abs().max().item())
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads) and len(got) == 68
    for k, g in want_grads.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0, atol=1e-4 * g.abs().max().item() + 1e-12,
                                   err_msg=k)


def test_three_adamw_steps_match_the_reference():
    """The parameters after 3 steps to 1e-7 absolute, a thousandth of the lr,
    in all but under 1% of the elements, and to 1e-6 in every one: AdamW's
    update is the gradient over its own scale, so the float32 differences of
    the gradients (above) reach the parameters at about 1e-3 of a step of size
    lr, and more where an element's gradient is near its own rounding noise."""
    model, params = _model(seed=5)
    b = _batch(seed=1)
    sched = SchedulerConfig(name="one_cycle_schedule", max_lr=OPT["lr"], num_training_steps=TOTAL, **ONE_CYCLE)
    tx = build_optimizer(OptimizerConfig(name="adamw", **OPT), schedules.resolve_schedule(sched, OPT["lr"], TOTAL),
                         b1_schedule=schedules.resolve_momentum_schedule(sched, TOTAL), device="cpu")
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, "rcan", compute_dtype=torch.float32, device="cpu")
    p, adam = dict(params), {}
    for t in range(3):
        state, metrics = step(state, {k: v.contiguous(memory_format=torch.channels_last) for k, v in b.items()})
        loss, grads, _ = ref.loss_and_grads(p, GEN, b, block=2, conv=esrgan.f32_conv)
        assert metrics["train/loss"].item() == pytest.approx(loss, rel=1e-5)
        lr, beta1 = ref_train.one_cycle(t, TOTAL, OPT["lr"], **ONE_CYCLE)
        p = ref_train.adamw(p, grads, adam, t + 1, lr, beta1, OPT["betas"][1], OPT["eps"], OPT["weight_decay"])
    got = model.state_dict()
    gap = torch.cat([(got[k] - p[k]).abs().flatten() for k in p])
    assert gap.max().item() <= 1e-6 and (gap > 1e-7).float().mean().item() < 0.01
    moved = max((p[k] - params[k]).abs().max().item() for k in p)
    assert moved > 1e-4  # the steps moved the parameters by more than the tolerance


def test_channel_attention_spans_and_counter():
    model, _ = _model()
    b = _batch()
    with torch.no_grad():
        off = model(b["lr"], b["elevation"], b["mask"])
        with profiling.recording() as rec:
            with profiling.span("climsr.step.forward"):
                on = model(b["lr"], b["elevation"], b["mask"])
        again = model(b["lr"], b["elevation"], b["mask"])
    ca = [s for s in rec.spans if s.name == "climsr.rcan.ca"]
    assert [s.key for s in ca] == list(range(6)) and rec.counts == {"climsr.rcan.ca_calls": 6}
    assert all(s.parent == 0 and s.end_ns >= s.start_ns > 0 for s in ca)
    assert len(rec.spans) == 7 and rec.counts["climsr.rcan.ca_calls"] == 6  # the forward after it records nothing
    assert torch.equal(off, on) and torch.equal(off, again)
