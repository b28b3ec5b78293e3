# -*- coding: utf-8 -*-
"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- off (the default), ``span`` is one shared no-op and ``count`` records nothing;
- on, a span keeps its name, thread, interval, parent and key, nested spans
  and another thread's span under a named parent included, on the clock of a
  ``torch.profiler`` trace: its interval brackets its own ``record_function``
  range there;
- a tiny tiled sweep records a ``climsr.sweep.load_month`` a month, the
  months written, and each group's writer stages under its enqueue span;
- a tiny pre-training epoch and a GAN epoch of the Trainer record a
  ``climsr.train.step`` a step, with the step's phases under it, and a
  ``climsr.optim.fused_updates`` for each optimizer update.
"""
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from climsr_tpu_torch.utils import profiling

torch.set_num_threads(1)

PRETRAIN_PHASES = ["climsr.step.prepare_batch", "climsr.step.forward", "climsr.step.backward",
                   "climsr.step.grad_norm", "climsr.step.optimizer"]
GAN_PHASES = ["climsr.step.prepare_batch", "climsr.gan.g_forward", "climsr.gan.d_forward", "climsr.gan.perceptual",
              "climsr.gan.g_backward", "climsr.gan.g_optimizer", "climsr.gan.d_forward", "climsr.gan.d_backward",
              "climsr.gan.d_optimizer"]


def test_off_records_nothing_and_returns_the_shared_no_op():
    a, b = profiling.span("climsr.a"), profiling.span("climsr.b", key=3)
    assert a is b
    with a as inside:
        assert inside is None
    assert profiling.count("climsr.n") is None
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    assert profiling.span("climsr.a") is a  # off again after the block


def test_on_records_name_thread_interval_parent_and_key():
    with profiling.recording() as rec:
        with profiling.span("climsr.outer", key=7) as outer:
            with profiling.span("climsr.inner") as inner:
                profiling.count("climsr.n")
            profiling.count("climsr.n", 2)

            def work():
                with profiling.span("climsr.writer", key=7, parent=outer):
                    with profiling.span("climsr.writer_child"):
                        pass

            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        with profiling.recording() as nested:  # a recording inside one is the same recorder
            assert nested is rec
    assert profiling.span("climsr.after") is profiling.span("climsr.other")
    names = [s.name for s in rec.spans]
    assert names == ["climsr.outer", "climsr.inner", "climsr.writer", "climsr.writer_child"]
    assert [s.index for s in rec.spans] == [0, 1, 2, 3]
    o, i, w, wc = rec.spans
    assert (o.parent, i.parent, w.parent, wc.parent) == (None, 0, 0, 2)
    assert (o.key, i.key, w.key, wc.key) == (7, None, 7, None)
    assert o.thread == i.thread == threading.get_native_id() == rec.thread
    assert w.thread == wc.thread != o.thread
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert o.start_ns <= w.start_ns <= wc.start_ns <= wc.end_ns <= w.end_ns <= o.end_ns
    assert inner is i and o.seconds > 0
    assert rec.counts == {"climsr.n": 3}


def test_span_brackets_its_record_function_range_on_the_profile_clock():
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with profiling.span("climsr.clock", key=k):
                torch.ones(64).add_(1)
    ranges = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "climsr.clock"),
                    key=lambda e: e.start_ns())
    assert len(ranges) == len(rec.spans) == 3
    for s, r in zip(rec.spans, ranges):
        assert s.start_ns <= r.start_ns() <= r.start_ns() + r.duration_ns() <= s.end_ns


def _world(root, months, h=16, w=32, scale=4):
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff
    from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series

    rng = np.random.default_rng(0)
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, : h // 8] = np.nan
    stamps = np.array([f"1901-{m % 12 + 1:02d}-16" for m in range(months)], dtype="datetime64[D]")
    write_climate_series(root / "cru_ts4.05.1901.2020.tmp.dat.nc",
                         ClimateSeries("tmp", data, stamps, np.linspace(-89, 89, h), np.linspace(-179, 179, w)))
    mask = np.where(rng.random((h * scale, w * scale)) > 0.5, 1.0, np.nan).astype(np.float32)
    mask[: h * scale // 8] = np.nan
    write_geotiff(root / "land_mask.tif", mask, GeoProfile.global_grid(h * scale, w * scale))
    elev = rng.normal(500, 300, size=(h * scale, w * scale)).astype(np.float32)
    write_geotiff(root / "elevation.tif", elev, GeoProfile.global_grid(h * scale, w * scale, nodata=None))


def test_tiny_sweep_records_months_groups_and_writer_stages(tmp_path):
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.models import create_generator

    months = 10  # two groups of 8, the second padded
    _world(tmp_path, months)
    ds = CRUTSInferenceDataset(ds_path=str(tmp_path / "cru_ts4.05.1901.2020.tmp.dat.nc"),
                               elevation_file=str(tmp_path / "elevation.tif"),
                               land_mask_file=str(tmp_path / "land_mask.tif"), generator_type="esrgan",
                               scaling_factor=4)
    model = create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, device="cpu")
    with profiling.recording() as rec:
        paths = inference_on_full_images(model, ds, str(tmp_path / "out"), "esrgan", batch_size=2, tile_size=16,
                                         tile_overlap=4, device="cpu")
    assert len(paths) == months
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert [s.key for s in by_name["climsr.sweep.load_month"]] == list(range(months))
    assert rec.counts == {"climsr.sweep.months": months, "climsr.sweep.groups": 2}
    enqueues = {s.key: s for s in by_name["climsr.sweep.enqueue"]}
    assert sorted(enqueues) == [0, 1] and sorted(s.key for s in by_name["climsr.sweep.writer_wait"]) == [0, 1]
    writer = [s for s in rec.spans if s.name in ("climsr.sweep.readback", "climsr.sweep.unpack12",
                                                 "climsr.sweep.denormalize", "climsr.sweep.write")]
    assert Counter(s.name for s in writer) == {"climsr.sweep.readback": 2, "climsr.sweep.unpack12": months,
                                               "climsr.sweep.denormalize": months, "climsr.sweep.write": months}
    for s in writer:
        assert s.parent == enqueues[s.key].index and s.thread != rec.thread
    assert all(s.thread == rec.thread for n in ("climsr.sweep.load_month", "climsr.sweep.enqueue",
                                                 "climsr.sweep.writer_wait") for s in by_name[n])
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("ds")
    make_synthetic_dataset(root, n_tiles_per_stage=(4, 2, 2))
    return root


def _trainer(world, workdir, overrides):
    from climsr_tpu_torch.cli.train import _flatten_task_cfg
    from climsr_tpu_torch.config import schemas
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule
    from climsr_tpu_torch.training.loop import Trainer

    cfg = compose(default_config_dir(), "config", overrides + [
        "generator.nf=8", "generator.nb=1", "generator.gc=8", "training.batch_size=2",
        "training.validation_batch_size=2", "training.num_workers=0", "trainer.limit_train_batches=2",
        "trainer.log_every_n_steps=2", "trainer.precision=fp32", "logger=csv", "print_config=false",
        f"datamodule.cfg.data_path={world}", "trainer.num_devices=1"])
    data_cfg = schemas.from_dict(schemas.SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
    gen = schemas.infer_generator_config(schemas.from_dict(schemas.GeneratorConfig, cfg["generator"]), data_cfg)
    return Trainer(
        datamodule=SuperResolutionDataModule(data_cfg), generator_cfg=gen,
        task_cfg=schemas.from_dict(schemas.TaskConfig, _flatten_task_cfg(cfg["task"])),
        trainer_cfg=schemas.from_dict(schemas.TrainerConfig, cfg["trainer"]),
        training_cfg=schemas.from_dict(schemas.TrainingConfig, cfg["training"]),
        discriminator_cfg=schemas.from_dict(schemas.DiscriminatorConfig, cfg.get("discriminator")),
        optimizers={k: schemas.from_dict(schemas.OptimizerConfig, v) for k, v in cfg["optimizers"].items()},
        schedulers={k: schemas.from_dict(schemas.SchedulerConfig, v) for k, v in cfg["schedulers"].items()},
        workdir=workdir, logger_cfg="csv", device="cpu")


@pytest.mark.parametrize("overrides, phases", [
    (["experiment=esrgan_pre_training"], PRETRAIN_PHASES),
    (["experiment=esrgan_fine_tune_no_gan_pre_training", "discriminator.name=default",
      "datamodule.cfg.europe_extent=false", "training.model_weights=null", "task.perceptual_cutoff=conv1_2"],
     GAN_PHASES),
], ids=["pretrain", "gan"])
def test_trainer_epoch_records_each_step_and_its_phases(tiny_world, tmp_path, overrides, phases):
    trainer = _trainer(tiny_world, tmp_path, overrides)
    try:
        with profiling.recording() as rec:
            trainer.train_epoch(0)
    finally:
        trainer.close()
    steps = [s for s in rec.spans if s.name == "climsr.train.step"]
    assert len(steps) == trainer.global_step == rec.counts["climsr.train.steps"] > 0
    assert [s.key for s in steps] == list(range(len(steps)))
    for s in steps:
        assert [c.name for c in rec.spans if c.parent == s.index] == phases
    logs = [s for s in rec.spans if s.name == "climsr.train.log"]
    assert logs and all(s.parent is None and s.key in range(1, len(steps) + 1) for s in logs)


@pytest.mark.parametrize("overrides, updates_per_step", [
    (["experiment=esrgan_pre_training"], 1),
    (["experiment=esrgan_fine_tune_no_gan_pre_training", "discriminator.name=default",
      "datamodule.cfg.europe_extent=false", "training.model_weights=null", "task.perceptual_cutoff=conv1_2"], 2),
], ids=["pretrain", "gan"])
def test_trainer_epoch_counts_each_fused_update(tiny_world, tmp_path, overrides, updates_per_step):
    """AdamW on f32 parameters takes torch's fused kernel: one update a
    pre-training step, two a GAN step (G and D)."""
    trainer = _trainer(tiny_world, tmp_path, overrides)
    try:
        with profiling.recording() as rec:
            trainer.train_epoch(0)
    finally:
        trainer.close()
    assert trainer.global_step > 0
    assert rec.counts["climsr.optim.fused_updates"] == updates_per_step * trainer.global_step
