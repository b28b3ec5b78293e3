# -*- coding: utf-8 -*-
"""The port's training entry point against the JAX package's, on the CPU.

- the slice as a whole: the JAX ``Trainer`` and the port's ``Trainer`` on
  one tiny synthetic set (ESRGAN nf=8 nb=1 gc=8, HR 128, batch 4, host
  augmentation, f32), the port starting from JAX's initial generator params
  (``state_dict_from_flax``): 2 optimizer steps and one validation, the
  logged ``train/loss`` and ``val/rmse`` and the final parameters compared.
  The JAX side is the run recorded in ``RECORD``; the test marked ``slow``
  (the JAX side alone takes ~25 s of CPU) runs it live and checks the record;
- the port's CLI (``--device=cpu``): fit/validate/test writes ``.ckpt`` files
  that ``load_generator_checkpoint`` reads, keeps the top k, logs
  ``metrics.csv``, resumes from the saved step, and writes nothing with
  ``save_top_k=0`` unless forced.
"""
import csv
import glob
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
warnings.filterwarnings("ignore", category=FutureWarning)

# ESRGAN at test width, 2 steps of batch 4 and one validation batch of 4
OVERRIDES = [
    "experiment=esrgan_pre_training", "generator.nf=8", "generator.nb=1", "generator.gc=8",
    "training.batch_size=4", "training.validation_batch_size=4", "training.num_workers=2",
    "trainer.max_epochs=1", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
    "trainer.limit_test_batches=1", "trainer.log_every_n_steps=1", "trainer.precision=fp32",
    "trainer.device_augment=false", "logger=csv", "print_config=false",
]


# the JAX Trainer's run on ``tiny_world``, written by ``python tests/test_torch_trainer.py``
RECORD = Path(__file__).parent / "fixtures" / "jax_trainer_record.npz"


def _tiny_world(root):
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(root, n_tiles_per_stage=(4, 2, 2))
    return root


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    return _tiny_world(tmp_path_factory.mktemp("ds"))


def _rows(path):
    """metrics.csv -> [{column: value}], a header row before each block."""
    out, header = [], None
    with open(path) as f:
        for cells in csv.reader(f):
            if cells[0] == "step":
                header = cells
            else:
                out.append({k: float(v) for k, v in zip(header, cells)})
    return out


def _build(pkg, world, workdir, **kw):
    """The JAX package's (``pkg="jax"``) or the port's Trainer, composed from
    ``OVERRIDES`` on ``world``."""
    if pkg == "jax":
        from climsr_tpu.cli.train import _flatten_task_cfg as flatten
        from climsr_tpu.config import schemas
        from climsr_tpu.config.compose import compose
        from climsr_tpu.data.datamodule import SuperResolutionDataModule
        from climsr_tpu.training.loop import Trainer
    else:
        from climsr_tpu_torch.cli.train import _flatten_task_cfg as flatten
        from climsr_tpu_torch.config import schemas
        from climsr_tpu_torch.config.compose import compose
        from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule
        from climsr_tpu_torch.training.loop import Trainer
    from climsr_tpu_torch.config.compose import default_config_dir

    cfg = compose(default_config_dir(), "config",
                  OVERRIDES + [f"datamodule.cfg.data_path={world}", "trainer.num_devices=1"])
    data_cfg = schemas.from_dict(schemas.SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
    gen = schemas.infer_generator_config(schemas.from_dict(schemas.GeneratorConfig, cfg["generator"]), data_cfg)
    return Trainer(
        datamodule=SuperResolutionDataModule(data_cfg), generator_cfg=gen,
        task_cfg=schemas.from_dict(schemas.TaskConfig, flatten(cfg["task"])),
        trainer_cfg=schemas.from_dict(schemas.TrainerConfig, cfg["trainer"]),
        training_cfg=schemas.from_dict(schemas.TrainingConfig, cfg["training"]),
        optimizers={k: schemas.from_dict(schemas.OptimizerConfig, v) for k, v in cfg["optimizers"].items()},
        schedulers={k: schemas.from_dict(schemas.SchedulerConfig, v) for k, v in cfg["schedulers"].items()},
        workdir=workdir, logger_cfg="csv", **kw)


def _logged(workdir, val) -> dict:
    """A run's logged train/loss per step, and its validation's val/rmse and hp_metric."""
    losses = [r["train/loss"] for r in _rows(f"{workdir}/metrics.csv") if "train/loss" in r]
    return {"train_loss": np.array(losses), "val_rmse": np.float64(val["val/rmse"]),
            "hp_metric": np.float64(val["hp_metric"])}


def jax_trainer_record(world, workdir) -> dict:
    """The JAX Trainer on ``world``: 2 steps and one validation. Returns the
    logged numbers and its initial and final generator parameters under the
    port's names (``init/<name>``, ``final/<name>``)."""
    import jax

    from climsr_tpu_torch.interop.params import state_dict_from_flax

    def params(trainer):
        flat = state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params)))
        return {k: v.numpy() for k, v in flat.items()}

    jt = _build("jax", world, workdir)
    init = params(jt)
    try:
        val = jt.fit()
    finally:
        jt.close()
    return {**_logged(workdir, val), **{f"init/{k}": v for k, v in init.items()},
            **{f"final/{k}": v for k, v in params(jt).items()}}


def _check_port_against(record, world, workdir):
    """The port's Trainer from the record's initial parameters, on the same
    data: its logged numbers and final parameters against the record's.
    Tolerances (f32, the same batches bit for bit): train/loss and val/rmse
    to 1e-5 relative; parameters to 1e-6 absolute after 2 AdamW steps (about
    1e-2 of the lr: the update normalises the f32 differences of the
    gradients' summation order)."""
    pt = _build("port", world, workdir, device="cpu")
    pt.g_model.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in record.items() if k.startswith("init/")},
                               strict=True)
    try:
        got = _logged(workdir, pt.fit())
    finally:
        pt.close()
    assert len(got["train_loss"]) == len(record["train_loss"]) == 2
    for k in ("train_loss", "val_rmse", "hp_metric"):
        np.testing.assert_allclose(got[k], record[k], rtol=1e-5, err_msg=k)
    for k, v in pt.g_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), record[f"final/{k}"], rtol=0, atol=1e-6, err_msg=k)


def test_trainer_matches_the_jax_trainers_record(tiny_world, tmp_path):
    """The port's Trainer against the JAX Trainer's run as recorded in
    ``RECORD`` (the slow test below checks the record against a live run)."""
    _check_port_against(dict(np.load(RECORD)), tiny_world, tmp_path)


@pytest.mark.slow  # ~25 s: the JAX Trainer's eager flax init compiles each op on the CPU
def test_trainer_matches_the_jax_trainer(tiny_world, tmp_path):
    """The port's Trainer against a live JAX Trainer run, and that run against
    ``RECORD`` (XLA's CPU code on another machine may sum in another order:
    1e-6 relative for the logged numbers, 1e-7 absolute for parameters)."""
    live = jax_trainer_record(tiny_world, tmp_path / "jax")
    _check_port_against(live, tiny_world, tmp_path / "port")
    record = np.load(RECORD)
    assert sorted(record.files) == sorted(live)
    for k, v in live.items():
        np.testing.assert_allclose(record[k], v, rtol=1e-6, atol=0 if k.count("/") == 0 else 1e-7, err_msg=k)


def _cli(tiny_world, out, *extra):
    from climsr_tpu_torch.cli.train import main

    return main(["--device=cpu", *OVERRIDES, f"datamodule.cfg.data_path={tiny_world}",
                 f"training.output_dir={out}", *extra])


def _run_dir(out):
    (run,) = glob.glob(f"{out}/outputs/runs/esrgan/*")
    return run


@pytest.fixture(scope="module")
def fitted(tiny_world, tmp_path_factory):
    """One CLI run: two epochs (device store, device augmentation), top-1
    kept, the simple profiler; (hp_metric, run directory)."""
    out = tmp_path_factory.mktemp("fitted")
    hp = _cli(tiny_world, out, "trainer.max_epochs=2", "trainer.device_augment=true", "trainer.save_top_k=1",
              "profiler=simple")
    return hp, _run_dir(out)


def test_cli_fit_validate_test_writes_checkpoints(fitted):
    """Two epochs (device store, device augmentation), top-1 kept: one
    ``.ckpt`` of the PL layout that loads into a fresh generator with
    ``strict=True``; metrics.csv has train, val and the three test sets; the
    simple profiler's stage table is written."""
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.training.checkpoint import CheckpointManager

    hp, run = fitted
    assert np.isfinite(hp)
    rows = _rows(f"{run}/metrics.csv")
    vals = [r for r in rows if "val/rmse" in r]
    assert [r["step"] for r in rows if "train/loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in vals] == [2, 4] and hp == pytest.approx(vals[-1]["val/rmse"])
    assert all(any(f"test/rmse/{i}" in r for r in rows) for i in range(3))
    assert "train_epoch" in open(f"{run}/profile_stages.txt").read()
    ckpts = glob.glob(f"{run}/checkpoints/*.ckpt")
    best = min(vals, key=lambda r: r["val/rmse"])["step"]
    mgr = CheckpointManager(f"{run}/checkpoints", save_top_k=1)
    assert len(ckpts) == 1 and mgr.best_step == mgr.latest_step == best
    ckpt = torch.load(ckpts[0], weights_only=True)
    assert ckpt["global_step"] == best and ckpt["epoch"] == best // 2 - 1
    assert ckpt["hyper_parameters"]["generator"]["nf"] == 8 and len(ckpt["optimizer_states"]) == 1
    assert ckpt["lr_schedulers"][0]["last_epoch"] == best
    model = create_generator("esrgan", device="cpu", nf=8, nb=1, gc=8, out_channels=1)
    model.load_state_dict(load_generator_checkpoint(ckpts[0]), strict=True)
    assert json.load(open(f"{run}/checkpoints/config.json"))["training"]["batch_size"] == 4


def test_cli_resume_and_fine_tune_continue_from_the_checkpoint(fitted, tiny_world, tmp_path):
    """Resume (``trainer.resume_from_checkpoint``, a checkpoint directory)
    continues at the saved step with the saved optimizer and schedule
    position; ``training.model_weights`` grafts the generator only."""
    from climsr_tpu_torch.training.checkpoint import load_checkpoint

    first = fitted[1]
    saved = load_checkpoint(f"{first}/checkpoints")
    g = saved["global_step"]
    assert g in (2, 4) and saved["optimizer_states"][0]["chain"]["updates"] == g
    _cli(tiny_world, tmp_path / "b", f"trainer.resume_from_checkpoint={first}/checkpoints", "trainer.save_top_k=-1")
    rows = _rows(f"{_run_dir(tmp_path / 'b')}/metrics.csv")
    assert [r["step"] for r in rows if "train/loss" in r] == [g + 1, g + 2]
    (after,) = glob.glob(f"{_run_dir(tmp_path / 'b')}/checkpoints/*.ckpt")
    after = torch.load(after, weights_only=True)
    assert after["global_step"] == g + 2 and after["optimizer_states"][0]["chain"]["updates"] == g + 2
    changed = [k for k, v in after["state_dict"].items() if not torch.equal(v, saved["state_dict"][k])]
    assert changed  # the two resumed steps moved the weights

    _cli(tiny_world, tmp_path / "c", f"training.model_weights={first}/checkpoints", "training.run_fit=false",
         "trainer.save_top_k=0")
    assert not glob.glob(f"{_run_dir(tmp_path / 'c')}/checkpoints/*.ckpt")
    rows = _rows(f"{_run_dir(tmp_path / 'c')}/metrics.csv")  # test only, on the grafted weights
    assert {"test/rmse/0", "test/rmse/1", "test/rmse/2"} <= set(rows[0]) | set(rows[1]) | set(rows[2])


def test_save_top_k_zero_writes_nothing_unless_forced(tiny_world, tmp_path, monkeypatch):
    """``save_top_k=0``: a fit writes no checkpoint; a SIGTERM during the
    epoch stops training at the next step and forces one (and skips test)."""
    import os
    import signal

    from climsr_tpu_torch.training import loop

    _cli(tiny_world, tmp_path / "a", "trainer.save_top_k=0")
    assert not glob.glob(f"{_run_dir(tmp_path / 'a')}/checkpoints/*.ckpt")

    real = loop.make_pretrain_step

    def make_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def sigterm_then_step(state, batch):
            os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch)

        return sigterm_then_step

    monkeypatch.setattr(loop, "make_pretrain_step", make_step)
    _cli(tiny_world, tmp_path / "b", "trainer.save_top_k=0", "trainer.max_epochs=5")
    run = _run_dir(tmp_path / "b")
    (ckpt,) = glob.glob(f"{run}/checkpoints/*.ckpt")
    assert torch.load(ckpt, weights_only=True)["global_step"] == 1
    # the preempted step is not logged, and no validation or test ran
    assert not os.path.exists(f"{run}/metrics.csv")


def test_checkpoint_manager_keeps_the_top_k(tmp_path):
    from climsr_tpu_torch.training.checkpoint import CheckpointManager, load_checkpoint

    mgr = CheckpointManager(tmp_path / "ck", save_top_k=2)
    for step, metric in ((1, 0.5), (2, 0.3), (3, 0.4), (4, None), (5, 0.6)):
        mgr.save(step, {"epoch": step, "global_step": step, "state_dict": {"w": torch.full((2,), float(step))}},
                 hp_metric=metric)
    kept = sorted(int(p.split("step=")[1].split(".")[0]) for p in glob.glob(f"{tmp_path}/ck/*.ckpt"))
    assert kept == [2, 3, 4] and mgr.best_step == 2 and mgr.latest_step == 4
    again = CheckpointManager(tmp_path / "ck", save_top_k=2)
    assert again.best_step == 2 and load_checkpoint(tmp_path / "ck")["global_step"] == 4
    assert float(again.restore(2)["state_dict"]["w"][0]) == 2.0
    assert CheckpointManager(tmp_path / "none", save_top_k=0).save(1, {"epoch": 0}) is None
    assert CheckpointManager(tmp_path / "forced", save_top_k=0).save(1, {"epoch": 0}, force=True).exists()
    with pytest.raises(FileNotFoundError, match="neither .* nor an orbax checkpoint"):
        load_checkpoint(tmp_path)  # a directory of neither the port's format nor orbax's


def test_gan_fine_tune_through_the_trainer(tiny_world, tmp_path):
    """The GAN task through the CLI: one G and D step, validation with the GAN
    val losses, and a checkpoint holding both models."""
    from climsr_tpu_torch.interop.params import load_discriminator_checkpoint

    hp = _cli(tiny_world, tmp_path, "task=gan_training", "discriminator={name: esrgan, in_channels: 1}",
              "task.perceptual_loss_factor=0", "trainer.limit_train_batches=1", "training.run_test_after_fit=false")
    assert np.isfinite(hp)
    rows = _rows(f"{_run_dir(tmp_path)}/metrics.csv")
    assert {"train/loss_G", "train/loss_D"} <= set(rows[0]) and "val/loss_G" in rows[1]
    (ckpt,) = glob.glob(f"{_run_dir(tmp_path)}/checkpoints/*.ckpt")
    assert load_discriminator_checkpoint(ckpt) and len(torch.load(ckpt, weights_only=True)["optimizer_states"]) == 2


def test_unported_options_raise_naming_their_roadmap_item(tiny_world, tmp_path, monkeypatch):
    """No option of the JAX Trainer raises as unported any more: what item 8
    refused across ranks (auto_scale_batch_size, and the pruning callbacks
    under ZeRO) builds and runs with the world the Trainer reads patched to
    4 ranks (``tests/test_torch_zero_services.py`` runs them on 4 real ones);
    the multi-GPU options (num_devices, ZeRO, spatial sharding), the options
    of item 9 and the callbacks of item 11 (auto_scale_batch_size, the
    jax/advanced/pytorch profilers, the pruning callbacks, log_images, the
    search, the LR range test) compose and build. On one process
    ``trainer.num_devices=2`` names the ranks it wants."""
    from climsr_tpu_torch.training import loop, lr_finder
    from climsr_tpu_torch.training.callbacks import LogImagesCallback, ModelPruningCallback, build_callbacks

    assert not hasattr(loop, "refuse_unported")
    built = []
    init = loop.Trainer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        built.append((type(self.callbacks[0]).__name__, self.callbacks[0].use_lottery_ticket_hypothesis,
                      self.trainer_cfg.auto_scale_batch_size))

    monkeypatch.setattr(loop.Trainer, "__init__", spy)
    monkeypatch.setattr(loop, "world", lambda: (0, 4))  # four ranks
    for i, extra in enumerate((["trainer.auto_scale_batch_size=power", "trainer.zero_stage=1",
                                "callbacks=[model_pruning]"],
                               ["trainer.shard_optimizer_state=true", "callbacks=[lottery_ticket]"])):
        assert np.isfinite(_cli(tiny_world, tmp_path / f"ranks{i}", *extra, "trainer.limit_train_batches=1",
                                "training.run_test_after_fit=false"))
    monkeypatch.undo()
    assert built == [("ModelPruningCallback", False, "power"), ("ModelPruningCallback", True, False)]
    from climsr_tpu_torch.parallel.mesh import create_mesh

    with pytest.raises(ValueError, match="the process group has 1 ranks"):
        create_mesh(2)  # the Trainer's mesh for trainer.num_devices=2
    for name in ("model_pruning", "lottery_ticket"):
        (cb,) = build_callbacks([name])
        assert isinstance(cb, ModelPruningCallback) and cb.use_lottery_ticket_hypothesis == (name != "model_pruning")
    (cb,) = build_callbacks(["log_images"])
    assert isinstance(cb, LogImagesCallback)
    assert len(build_callbacks(["learning_rate_monitor", "device_stats_monitor", "early_stopping"])) == 2
    lr_finder.lr_range_test.__defaults__, kept = (1e-7, 1.0, 6, 0.98), lr_finder.lr_range_test.__defaults__
    try:
        for i, extra in enumerate((["hparams_search=srcnn_optuna", "hparams_search.n_trials=1"],
                                   ["training.lr_find_only=true"], ["profiler=pytorch"])):
            assert np.isfinite(_cli(tiny_world, tmp_path / str(i), *extra))
    finally:
        lr_finder.lr_range_test.__defaults__ = kept
    assert glob.glob(f"{tmp_path}/0/hparams_search/trials.csv") and glob.glob(f"{tmp_path}/0/hparams_search/best.yaml")
    assert glob.glob(f"{tmp_path}/1/outputs/runs/esrgan/*/lr_find.csv")
    assert glob.glob(f"{tmp_path}/2/outputs/runs/esrgan/*/profile_ops.txt")


if __name__ == "__main__":  # write RECORD from the JAX Trainer, on the virtual CPU devices of the tests
    import sys
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import conftest  # noqa: F401  (the JAX platform set-up of the tests)

    with tempfile.TemporaryDirectory() as tmp:
        record = jax_trainer_record(_tiny_world(Path(tmp) / "ds"), Path(tmp) / "jax")
    np.savez_compressed(RECORD, **record)
    print(f"wrote {RECORD}: {len(record)} arrays")
