# -*- coding: utf-8 -*-
"""The training entry point's services in the port against the JAX package's, on the CPU.

- batch probe: ``probe_max_batch_size`` of both on the same scripted
  ``_fits`` predicates (``tests/test_batch_probe.py``'s six cases) gives the
  same batch or the same error; the port's ``fits`` gives None on the CPU and
  the CLI keeps the configured batch;
- LR range test: ``lr_range_test`` of both on one tiny ESRGAN (nf=8, nb=1,
  gc=8, f32, JAX's init carried over by ``state_dict_from_flax``) and the same
  index batches from a tile store, augmentation off: equal LR sequences and
  history lengths, losses within 1e-4 relative (f32 summation order through 8
  SGD steps), and the port's suggestion on JAX's history equal to JAX's; the
  CLI's ``training.lr_find_only`` writes ``lr_find.csv``;
- hyperparameter search: ``run_search`` of both on the same seeded
  objectives (random and TPE sampling, failures, median pruning, a pruned
  trial never best, resume) write identical ``trials.csv`` files and the same
  best, and ``best.yaml`` loads to the same values; ``dump_yaml`` round-trips
  through ``load_yaml``;
- profiler: ``format_op_table`` prints JAX's table for the same totals, and
  ``profiler=advanced`` on the CPU writes a non-empty ``profile_ops.txt``.
"""
import csv
import glob
import math
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.training import lr_finder as jax_lr_finder
from climsr_tpu.training.batch_probe import probe_max_batch_size as jax_probe
from climsr_tpu.training.hparams_search import run_search as jax_run_search
from climsr_tpu.utils.profiling import format_op_table as jax_format_op_table
from climsr_tpu_torch.config.yaml_subset import dump_yaml, load_yaml
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.training import batch_probe, lr_finder
from climsr_tpu_torch.training.hparams_search import run_search
from climsr_tpu_torch.utils.profiling import format_op_table

torch.set_num_threads(1)
warnings.filterwarnings("ignore", category=FutureWarning)

CLI = [
    "experiment=esrgan_pre_training", "generator.nf=8", "generator.nb=1", "generator.gc=8",
    "training.batch_size=4", "training.validation_batch_size=4", "training.num_workers=2",
    "trainer.max_epochs=1", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
    "trainer.limit_test_batches=1", "trainer.precision=fp32", "logger=csv", "print_config=false",
    "training.run_test_after_fit=false",
]


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("ds")
    make_synthetic_dataset(root, n_tiles_per_stage=(4, 2, 2))
    return root


def _cli(tiny_world, out, *extra):
    from climsr_tpu_torch.cli.train import main

    return main(["--device=cpu", *CLI, f"datamodule.cfg.data_path={tiny_world}", f"training.output_dir={out}", *extra])


# ---- batch probe -------------------------------------------------------------

def _capacity(cap):
    """Batches up to ``cap`` fit; 2 plan bytes a sample."""
    return lambda bs: (bs <= cap, bs * 2)


@pytest.mark.parametrize("kwargs", [
    dict(start=8, mode="power", _fits=_capacity(100)),
    dict(start=8, mode="binsearch", _fits=_capacity(100)),
    dict(start=256, mode="power", _fits=_capacity(100)),
    dict(start=4, mode="power", _fits=lambda bs: (False, 0)),
    dict(start=32, mode="power", _fits=lambda bs: None),
    dict(start=1, mode="power", max_trials=3, _fits=_capacity(10 ** 9)),
], ids=["power", "binsearch", "scale-down", "batch-one-too-big", "no-memory-stats", "max-trials"])
def test_probe_search_matches_jax(kwargs):
    """The search is JAX's: the same scripted predicate gives the same batch (64,
    65-100, 64, ValueError, 32, 8 as in tests/test_batch_probe.py)."""
    try:
        want = jax_probe(None, None, {}, **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError, match="batch_size=1"):
            batch_probe.probe_max_batch_size(None, None, {}, **kwargs)
        assert "batch_size=1" in str(e)
        return
    assert batch_probe.probe_max_batch_size(None, None, {}, **kwargs) == want


def test_probe_fits_is_none_on_the_cpu_and_the_cli_keeps_the_batch(tiny_world, tmp_path):
    """On the CPU ``fits`` reads no memory statistics (None), so the Trainer
    keeps the configured batch, as the JAX probe on a backend without them."""
    from climsr_tpu_torch.training import loop

    template = {"lr": torch.zeros(1, 3, 8, 8), "hr": torch.zeros(1, 1, 32, 32)}
    assert batch_probe.fits(None, None, template, 4, 0.9) is None
    kept = []
    init = loop.Trainer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        kept.append((self.dm.cfg.batch_size, list(self.batch_trials)))

    loop.Trainer.__init__ = spy
    try:
        assert np.isfinite(_cli(tiny_world, tmp_path, "trainer.auto_scale_batch_size=binsearch"))
    finally:
        loop.Trainer.__init__ = init
    assert kept == [(4, [])]


# ---- LR range test -----------------------------------------------------------

class _Loader:
    """Index batches of 2 over 6 tiles, a seeded permutation per epoch."""

    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        order = np.random.default_rng(self.epoch).permutation(6)
        return iter([order[i:i + 2] for i in range(0, 6, 2)])


class _Trainer:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def _generator_params(self):
        return self.params


def test_lr_range_test_matches_jax(rng, tmp_path):
    data = {"lr": rng.normal(size=(6, 8, 8, 3)), "hr": rng.normal(size=(6, 32, 32, 1)) * 0.5,
            "elevation": rng.normal(size=(6, 32, 32, 1)), "mask": (rng.random((6, 32, 32, 1)) > 0.3) * 1.0}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    model = jax_create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, use_pallas=False, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), data["lr"][:2], data["elevation"][:2], data["mask"][:2])["params"]
    kw = dict(min_lr=1e-4, max_lr=1.0, num_steps=8)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jt = _Trainer(g_model=model, generator_type="esrgan", params=params, _augment_kwargs=None,
                  compute_dtype=jnp.float32, train_store={k: jnp.asarray(v) for k, v in data.items()},
                  train_loader=_Loader(), batch_sharding=None, workdir=tmp_path / "jax")
    want_s, want = jax_lr_finder.lr_range_test(jt, **kw)

    port = create_generator("esrgan", dtype=torch.float32, device="cpu", train=True, nf=8, nb=1, gc=8,
                            out_channels=1)
    port.load_state_dict(state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    store = {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() for k, v in data.items()}
    pt = _Trainer(g_model=port, generator_type="esrgan", _augment_kwargs=None, compute_dtype=torch.float32,
                  train_store=store, train_loader=_Loader(), device=torch.device("cpu"), workdir=tmp_path / "port")
    got_s, got = lr_finder.lr_range_test(pt, **kw)

    assert got["lr"] == want["lr"] and len(got["loss"]) == len(want["loss"]) >= 5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["smoothed"], want["smoothed"], rtol=1e-4)
    assert lr_finder.suggest(want["lr"], want["smoothed"], kw["min_lr"]) == want_s
    assert got_s in got["lr"]
    # the generator the trainer holds is not touched: the sweep runs on a copy
    ref = state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params))
    assert all(torch.equal(p, ref[k]) for k, p in port.state_dict().items())
    with open(tmp_path / "port" / "lr_find.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["lr", "loss", "smoothed"] and len(rows) == len(got["lr"]) + 1


def test_cli_lr_find_only_writes_the_sweep(tiny_world, tmp_path, monkeypatch):
    """The CLI runs the sweep instead of the fit (8 steps here: the CLI takes
    lr_range_test's defaults, 100 steps of HR 128 tiles, ~25 s on the CPU)."""
    monkeypatch.setattr(lr_finder.lr_range_test, "__defaults__", (1e-7, 1.0, 8, 0.98))
    suggestion = _cli(tiny_world, tmp_path, "training.lr_find_only=true")
    (run,) = glob.glob(f"{tmp_path}/outputs/runs/esrgan/*")
    with open(f"{run}/lr_find.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["lr", "loss", "smoothed"] and len(rows) == 9
    assert suggestion in [float(r[0]) for r in rows[1:]]
    assert not glob.glob(f"{run}/checkpoints/*.ckpt")  # no fit


# ---- hyperparameter search ---------------------------------------------------

def _x(overrides):
    return int([o for o in overrides if o.startswith("x=")][0].split("=")[1])


def _quadratic(overrides):
    return float((_x(overrides) - 2) ** 2)


def _flaky(overrides):
    if _x(overrides) == 0:
        raise RuntimeError("boom")
    return 1.0 + 0.1 * _x(overrides)


def _converging(overrides, report):
    x = _x(overrides)
    for step in range(5):
        report(step, (1.0 if x else 10.0) / (step + 1))
    return (1.0 if x else 10.0) / 5


def _early_star(overrides, report):
    x = _x(overrides)
    for step in range(4):
        report(step, 0.01 if (x == 0 and step == 0) else (5.0 if x == 0 else 1.0))
    return 5.0 if x == 0 else 1.0


SEARCHES = {
    "random": (dict(n_trials=8, sampler=dict(name="random", seed=1),
                    search_space=dict(x=dict(type="categorical", choices=[1, 2, 3]))), _quadratic),
    "tpe": (dict(n_trials=10, sampler=dict(name="tpe", seed=7, n_startup_trials=3),
                 search_space=dict(x=dict(type="categorical", choices=[0, 1, 2, 3]),
                                   y=[[-1.0, 1.0], [0.0, 1.0]])), _quadratic),
    "failures": (dict(n_trials=4, sampler=dict(name="random", seed=0),
                      search_space=dict(x=dict(type="categorical", choices=[0, 1]))), _flaky),
    "median-pruning": (dict(n_trials=8, sampler=dict(name="random", seed=3),
                            pruner=dict(name="median", n_startup_trials=2, n_warmup_steps=0),
                            search_space=dict(x=dict(type="categorical", choices=[0, 1]))), _converging),
    "pruned-never-best": (dict(n_trials=6, sampler=dict(name="random", seed=3),
                               pruner=dict(name="median", n_startup_trials=2, n_warmup_steps=0),
                               search_space=dict(x=dict(type="categorical", choices=[0, 1]))), _early_star),
}


def _both(cfg, objective, root):
    """run_search of JAX (into root/jax) and of the port (root/port)."""
    jax_best, jax_trials = jax_run_search([], cfg, objective, output_dir=str(root / "jax"))
    best, trials = run_search([], cfg, objective, output_dir=str(root / "port"))
    return (jax_best, jax_trials), (best, trials)


def _assert_same(root, jax_out, port_out):
    (jax_best, jax_trials), (best, trials) = jax_out, port_out
    assert (root / "port" / "trials.csv").read_text() == (root / "jax" / "trials.csv").read_text()
    assert [(t.number, t.params, t.value, t.state, t.intermediate) for t in trials] == \
        [(t.number, t.params, t.value, t.state, t.intermediate) for t in jax_trials]
    assert (best is None) == (jax_best is None)
    if best is not None:
        assert (best.number, best.params, best.value) == (jax_best.number, jax_best.params, jax_best.value)
        assert load_yaml((root / "port" / "best.yaml").read_text()) == \
            yaml.safe_load((root / "jax" / "best.yaml").read_text())


@pytest.mark.parametrize("case", list(SEARCHES) + ["resume"])
def test_run_search_matches_jax(tmp_path, case):
    """Trial by trial the same params, values, states and reports, the same
    ``trials.csv`` bytes, the same best and ``best.yaml`` values. ``resume``:
    4 trials, then the same directories resumed to 7."""
    if case == "resume":
        cfg, objective = SEARCHES["random"]
        _both(dict(cfg, n_trials=4), objective, tmp_path)
        jax_out, port_out = _both(dict(cfg, n_trials=7), objective, tmp_path)
        assert [t.number for t in port_out[1]] == list(range(7))
    else:
        cfg, objective = SEARCHES[case]
        jax_out, port_out = _both(cfg, objective, tmp_path)
    _assert_same(tmp_path, jax_out, port_out)
    states = {t.state for t in port_out[1]}
    assert ("PRUNED" in states) == ("pruning" in case or case == "pruned-never-best")
    assert ("FAILED" in states) == (case == "failures")


@pytest.mark.parametrize("data", [
    {"value": 0.123456789, "params": {"training.lr": 1e-05, "training.batch_size": 192,
                                      "datamodule.cfg.normalization_range": [-1.0, 1.0],
                                      "datamodule.cfg.resolutions": ["2.5m", "5m"],
                                      "datamodule.cfg.use_mask": True, "x": None}},
    {"a": {"b": {"c": 'quote " and \\ backslash', "d": []}, "e": {}}, "f": [[1, 2], [3.5, -0.0]],
     "g": float("inf"), "h": -1e300, "i": "yes", "j": "123", "k": "null"},
    [1, "two", 3.0],
], ids=["best-yaml", "nested-and-awkward", "top-level-list"])
def test_dump_yaml_round_trips_through_load_yaml(data):
    """What ``best.yaml`` holds (and strings YAML would read as other types)
    loads back equal; PyYAML reads the same text to the same values."""
    text = dump_yaml(data)
    assert load_yaml(text) == data
    assert yaml.safe_load(text) == data


# ---- profiler ----------------------------------------------------------------

def test_format_op_table_matches_jax():
    totals = {"void (anonymous namespace)::rdb_fwd_bf16_kernel<1, false>(__nv_bfloat16 const*, __nv_bfloat16 "
              "const*, __nv_bfloat16*)": (0.0231, 66), "conv9_dx_c0_bf16_kernel": (0.00078, 2),
              "copy-start.3": (0.5, 4), "fusion.12": (1e-7, 1), "ampere_bf16_s16816gemm": (0.0151, 12)}
    for top in (40, 2):
        assert format_op_table(totals, top=top) == jax_format_op_table(totals, top=top)
    assert format_op_table({}) == jax_format_op_table({})


def test_cli_advanced_profiler_writes_an_op_table(tiny_world, tmp_path):
    """On the CPU the table sums the ops' self CPU time (no device events),
    over epoch 0, beside the stage table."""
    assert math.isfinite(_cli(tiny_world, tmp_path, "profiler=advanced"))
    (run,) = glob.glob(f"{tmp_path}/outputs/runs/esrgan/*")
    table = open(f"{run}/profile_ops.txt").read().splitlines()
    assert table[0].strip().startswith(f"torch {torch.__version__}") and "TOTAL (compute events)" in table[-1]
    rows = [line for line in table[2:-1] if "ms" in line]
    assert rows and any("FusedRDB" in line for line in rows)
    assert open(f"{run}/profile_stages.txt").read().strip()
    assert glob.glob(f"{run}/profiles/trace.json")
