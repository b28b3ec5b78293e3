# -*- coding: utf-8 -*-
"""The Trainer's model-changing callbacks under ZeRO 1-3 and its batch probe
over the ranks, on 4 gloo ranks of the CPU, against the JAX package's
``ModelPruningCallback`` and ``probe_max_batch_size`` and against the
single-process port.

One group of 4 ranks runs ``cli.train`` (``parallel.cases.suite_zero_services``;
fresh interpreters that import no JAX) on a tiny synthetic set with the
ESRGAN of ``cases.TRAIN_OVERRIDES`` (nf=32, nb=1, gc=16, f32: its three conv5
weights have 2**14 elements or more and are sharded), 2 epochs of 1 step:

- ``model_pruning`` and ``lottery_ticket`` at ZeRO stages 1, 2 and 3: each
  rank's masks are, exactly, the JAX callback's on the gathered weights the
  pruning read (which are the same on every rank), and the pruned weights are
  the JAX callback's; after the next epoch's steps every position pruned
  before is still 0, in the gathered weights and in each rank's shards;
  sparsity 50%, then 75%; the weights and the train losses are the
  single-process port's with the same callback (first-step loss rtol 1e-6,
  later 1e-5, parameters atol 1e-6, as ``tests/test_torch_parallel.py``);
- ``trainer.auto_scale_batch_size`` in ``power`` and ``binsearch`` with a
  stand-in for the trials (``cases.stand_in_fits``: a global batch fits where
  a rank's slice holds at most 3 samples): only rank 0 runs trials, each at
  the data axis's 4 shards and a quarter of the headroom (the 4 ranks share
  one device), every rank ends with the same batch, and that batch is JAX's
  ``probe_max_batch_size(..., shards=4)`` with the same stand-in.
"""
import csv
import glob

import numpy as np
import pytest
import torch

import climsr_tpu.training.batch_probe as jax_batch_probe
from climsr_tpu.training.callbacks import ModelPruningCallback as JaxPruning
from climsr_tpu_torch.parallel import cases
from climsr_tpu_torch.parallel.launch import spawn
from climsr_tpu_torch.training.loop import PROBE_HEADROOM

torch.set_num_threads(1)
RANKS = 4
STAGES = (1, 2, 3)
EPOCHS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The suite on 4 gloo ranks: (workdir, [per-rank results])."""
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    workdir = tmp_path_factory.mktemp("zero_services")
    make_synthetic_dataset(workdir / "ds", n_tiles_per_stage=(4, 1, 1))
    np.savez(workdir / "inputs.npz", unused=np.zeros(1))
    spawn("climsr_tpu_torch.parallel.cases:main", RANKS, {"workdir": str(workdir), "suites": ["zero_services"]},
          env={"OMP_NUM_THREADS": "1"}, timeout=600)
    return workdir, [dict(np.load(workdir / f"zero_services_rank{r}.npz")) for r in range(RANKS)]


@pytest.fixture(scope="module")
def single(ranks, tmp_path_factory):
    """The single-process port with each callback on the same set: {lottery: (record, run dir)}."""
    workdir, _ = ranks
    out = tmp_path_factory.mktemp("single")
    return {lottery: cases.pruning_fit(str(workdir / "ds"), str(out / str(lottery)), lottery)
            for lottery in (False, True)}


class _JaxTrainer:
    def __init__(self, params):
        self.params = params

    def _generator_params(self):
        return self.params

    def _set_generator_params(self, params):
        self.params = params


def _weights(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _logged(run, key):
    """The values of ``key`` in a run's metrics.csv (a header row before each block)."""
    out, header = [], None
    with open(f"{run}/metrics.csv") as f:
        for cells in csv.reader(f):
            if cells[0] == "step":
                header = cells
            elif key in header:
                out.append(float(cells[header.index(key)]))
    return out


@pytest.mark.parametrize("lottery", [False, True], ids=["model_pruning", "lottery_ticket"])
@pytest.mark.parametrize("stage", STAGES)
def test_pruning_under_zero_matches_jax_and_one_process(ranks, single, stage, lottery):
    _, res = ranks
    tag = f"s{stage}{'lottery' if lottery else 'pruning'}"
    r0 = res[0]
    jcb = JaxPruning(use_lottery_ticket_hypothesis=lottery)
    jt = _JaxTrainer(_weights(r0, f"{tag}/start/"))
    jcb.on_fit_start(jt)
    record, run = single[lottery]
    for e, sparsity in zip(range(EPOCHS), (0.5, 0.75)):
        p = f"{tag}/e{e}"
        jt.params = _weights(r0, f"{p}/before/")
        jcb.on_train_epoch_end(jt, e)
        masks = {k: jcb._masks[k] for k in jt.params if jcb._masks[k] is not None}
        assert len(masks) == len(_weights(r0, f"{p}/mask/")) > 0
        for r, out in enumerate(res):
            assert str(out[f"{p}/digest"]) == str(r0[f"{p}/digest"]), r  # the same weights on every rank
            for k, m in masks.items():
                assert out[f"{p}/mask/{k}"].dtype == bool and np.array_equal(out[f"{p}/mask/{k}"], m), (r, k)
            assert float(out[f"{p}/sparsity"]) == pytest.approx(sparsity, abs=0.01)
            # the positions pruned at the epoch before are still 0 after this epoch's steps, and this
            # epoch's are 0 after the pruning: in the gathered weights and in the rank's shards
            assert tuple(out[f"{p}/kept"]) == (True, True) and tuple(out[f"{p}/pruned"]) == (True, True), r
        after = _weights(r0, f"{p}/after/")
        for k, v in jt.params.items():
            assert np.array_equal(after[k], np.asarray(v)), k  # the JAX callback's pruned (and rewound) weights
        zeros = sum(int((after[k][~m] == 0).sum()) for k, m in masks.items())
        assert zeros == sum(int((~m).sum()) for m in masks.values())
        # against one process with the same callback
        want = record[e + 1]
        for what in ("before", "after"):
            got = _weights(r0, f"{p}/{what}/")
            assert got.keys() == want[what].keys()
            for k, v in want[what].items():
                np.testing.assert_allclose(got[k], v.numpy(), atol=1e-6, rtol=0, err_msg=f"{what} {k}")
    losses, want = _logged(r0[f"{tag}/run"], "train/loss"), _logged(run, "train/loss")
    assert len(losses) == len(want) == EPOCHS
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(losses[1:], want[1:], rtol=1e-5)
    rmse, want = _logged(r0[f"{tag}/run"], "val/rmse"), _logged(run, "val/rmse")
    assert len(rmse) == len(want) == EPOCHS
    np.testing.assert_allclose(rmse, want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["power", "binsearch"])
def test_probe_over_ranks_matches_jax(ranks, mode, monkeypatch):
    _, res = ranks
    calls = []
    monkeypatch.setattr(jax_batch_probe, "fits", cases.stand_in_fits(calls))
    want = jax_batch_probe.probe_max_batch_size(None, None, {}, start=4, mode=mode, shards=RANKS)
    assert want > 4  # the stand-in lets the global batch grow past the configured one
    got = [int(out[f"probe_{mode}/batch"]) for out in res]
    assert got == [want] * RANKS
    trials = res[0][f"probe_{mode}/calls"]
    assert trials[:, 0].tolist() == [bs for bs, _, _ in calls]  # rank 0 ran JAX's trials
    assert (trials[:, 1] == RANKS).all() and np.allclose(trials[:, 2], PROBE_HEADROOM / RANKS)
    assert all(out[f"probe_{mode}/calls"].size == 0 for out in res[1:])  # the others ran none
    assert glob.glob(f"{ranks[0]}/probe_{mode}/outputs/runs/esrgan/*")
