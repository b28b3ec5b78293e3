# -*- coding: utf-8 -*-
"""The port's metric suite and eval step against the JAX package's and the torchmetrics goldens.

``tests/fixtures/metric_goldens.npz`` holds values from an independent torch
implementation of the torchmetrics algorithms (``scripts/gen_metric_goldens.py``);
the JAX suite is held against the same file by ``tests/test_metric_goldens.py``.
Tolerances: the goldens' own (2e-4 relative, 2e-5 absolute); against JAX
1e-5 relative for the suite on the same arrays (f32, summation order) and
1e-4 for the eval step, whose generator output carries the convs' summation
order into the denormalised metrics.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.metrics.regression_accuracy import RegressionAccuracy as JaxRegressionAccuracy
from climsr_tpu.metrics.suite import compute_metric_suite as jax_compute_metric_suite
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.training.tasks.pretrain import make_eval_step as jax_make_eval_step
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.metrics import functional as F
from climsr_tpu_torch.metrics.regression_accuracy import RegressionAccuracy
from climsr_tpu_torch.metrics.suite import compute_metric_suite
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.training.tasks.pretrain import make_eval_step

torch.set_num_threads(1)

_FIXTURE = Path(__file__).with_name("fixtures") / "metric_goldens.npz"

_METRICS = {
    "psnr": F.psnr,
    "ssim": F.ssim,
    "mae": F.mae,
    "mse": F.mse,
    "rmse": F.rmse,
    "mape": F.mape,
    "smape": F.smape,
    "r2": F.r2_score,
    "acc@0.1": lambda p, t: F.regression_accuracy(p, t, eps=0.1),
    "acc@0.5": lambda p, t: F.regression_accuracy(p, t, eps=0.5),
    "acc@1.0": lambda p, t: F.regression_accuracy(p, t, eps=1.0),
}


@pytest.fixture(scope="module")
def goldens():
    return np.load(_FIXTURE)


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_METRICS))
def test_metric_matches_torch_golden(goldens, case, name):
    preds = torch.from_numpy(goldens[f"case{case}_preds"])  # NCHW f32
    target = torch.from_numpy(goldens[f"case{case}_target"])
    key = name if not name.startswith("acc@") else f"acc@{float(name.split('@')[1])}"
    want = float(goldens[f"case{case}_{key}"])
    got = float(_METRICS[name](preds, target))
    assert got == pytest.approx(want, rel=2e-4, abs=2e-5), (name, case, got, want)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def test_suite_matches_jax_with_the_reference_labels(rng):
    arrays = [rng.normal(size=(2, 16, 20, 1)).astype(np.float32) * s for s in (1.0, 1.0, 10.0, 10.0)]
    want = jax_compute_metric_suite(*(jnp.asarray(a) for a in arrays), mode="test")
    got = compute_metric_suite(*(_nchw(a) for a in arrays), mode="test")
    assert sorted(got) == sorted(want) and "test/acc@01.25" in got and len(got) == 16
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-6), k


def test_regression_accuracy_accumulates_as_jax(rng):
    ours, theirs = RegressionAccuracy(eps=0.5), JaxRegressionAccuracy(eps=0.5)
    for _ in range(3):
        p, t = rng.normal(size=(2, 1, 5, 6)).astype(np.float32), rng.normal(size=(2, 1, 5, 6)).astype(np.float32)
        assert float(ours(torch.from_numpy(p), torch.from_numpy(t))) == pytest.approx(
            float(theirs(jnp.asarray(p), jnp.asarray(t))))
    assert float(ours.compute()) == pytest.approx(float(theirs.compute()))
    with pytest.raises(ValueError):
        ours.update(torch.zeros(2), torch.zeros(3))


@pytest.mark.parametrize("normalization", ["minmax", "zscore"])
def test_eval_step_matches_jax(rng, normalization):
    """The 16 metrics and the losses of one ESRGAN eval step (nf=16, nb=1, gc=8,
    8x16 LR, masked, denormalised) against the JAX eval step with the Pallas trunk."""
    n, h, w = 2, 8, 16
    batch = {
        "lr": rng.normal(size=(n, h, w, 3)).astype(np.float32),
        "hr": rng.uniform(-1, 1, size=(n, 4 * h, 4 * w, 1)).astype(np.float32),
        "elevation": rng.normal(size=(n, 4 * h, 4 * w, 1)).astype(np.float32),
        "mask": (rng.random((n, 4 * h, 4 * w, 1)) > 0.3).astype(np.float32),
        "original_data": rng.normal(10, 5, size=(n, 4 * h, 4 * w, 1)).astype(np.float32),
        "min": np.array([-5.0, 0.0], np.float32),
        "max": np.array([20.0, 30.0], np.float32),
    }
    model = jax_create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=1, use_pallas=True, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), batch["lr"], batch["elevation"], batch["mask"])["params"]
    kwargs = dict(normalization_method=normalization, zscore_mean=3.0, zscore_std=2.0)
    want = jax_make_eval_step(model, "esrgan", compute_dtype=jnp.float32, **kwargs)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    port = create_generator("esrgan", device="cpu", train=True, nf=16, nb=1, gc=8, out_channels=1)
    port.load_state_dict(state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tbatch = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v)) for k, v in batch.items()}
    got = make_eval_step(port, "esrgan", compute_dtype=torch.float32, device="cpu", **kwargs)(tbatch)
    assert sorted(got) == sorted(want) and len(got) == 18
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), k
