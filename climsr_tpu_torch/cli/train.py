# -*- coding: utf-8 -*-
"""Training CLI: config composition -> datamodule -> Trainer -> fit/test. The
port of ``climsr_tpu.cli.train``.

Parity: reference ``climsr/cli/train.py`` — ``run()`` wires datamodule, task
and trainer from the composed config; ``main()`` composes it from ``conf/``
and the overrides. The top-level config groups are stitched into the task
(optimizers/schedulers/generator/discriminator, ``:160-164``),
``infer_generator_config`` does the channel arithmetic, fit then test run,
and the optimized metric is returned (``:143-144``).

Usage, on the card::

    python -m climsr_tpu_torch.cli.train experiment=esrgan_pre_training datamodule.cfg.data_path=...

A leading ``--device=cpu`` runs on the CPU; it is not a config key, so the
composed config is the JAX package's. ``training.lr_find_only=true`` runs the
LR range test instead of the fit (``training/lr_finder.py``), and an
``hparams_search=<preset>`` runs the sweep (``training/hparams_search.py``),
one ``run`` per trial (:func:`run_hparams_search`), as the JAX CLI does.

Several ranks: called inside an initialized ``torch.distributed`` group
(``torchrun``, or a caller's own group) the run takes that group; otherwise
``trainer.num_devices=N`` (N > 1) makes :func:`main` start N ranks itself,
NCCL with one card per rank on ``cuda`` (it raises where there are fewer
cards) and gloo on the CPU. Every rank resolves rank 0's run directory
(``broadcast_string``); ``plugins=spatial_shard`` and ``trainer.zero_stage``
/ ``shard_optimizer_state`` reach the Trainer as in the JAX CLI.
"""
from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from climsr_tpu_torch.config.compose import ConfigError, compose, default_config_dir
from climsr_tpu_torch.config.schemas import (
    DiscriminatorConfig,
    GeneratorConfig,
    OptimizerConfig,
    SchedulerConfig,
    SuperResolutionDataConfig,
    TaskConfig,
    TrainerConfig,
    TrainingConfig,
    from_dict,
    infer_generator_config,
)
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.parallel.launch import init_from_env, spawn
from climsr_tpu_torch.parallel.mesh import broadcast_string, world

logger = logging.getLogger(__name__)

class _ReportCallback:
    """Passes each validation's optimized metric to ``run``'s ``report_cb`` as
    ``report_cb(epoch, value)``."""

    def __init__(self, report, metric: str):
        self._report = report
        self._metric = metric

    def on_validation_end(self, trainer, epoch: int, val_metrics: Dict[str, float]) -> None:
        value = val_metrics.get(self._metric, val_metrics.get("hp_metric"))
        if value is not None:
            self._report(epoch, float(value))


def _flatten_task_cfg(task_dict):
    """Reference-compat aliasing: the reference's task group nests its knobs
    under ``cfg`` (hydra ``task.cfg.*`` override paths); ours is flat — accept
    both by folding task.cfg.* into task.* (the nested key wins)."""
    if isinstance(task_dict, dict) and isinstance(task_dict.get("cfg"), dict):
        return {**{k: v for k, v in task_dict.items() if k != "cfg"}, **task_dict["cfg"]}
    return task_dict


def run(cfg: Dict[str, Any], report_cb=None, datamodule=None, device: DeviceLike = None) -> Optional[float]:
    """Fit and test from a composed config; returns the optimized metric
    (``hp_metric`` by default). ``datamodule`` replaces the one the config's
    ``datamodule.cfg`` would read from disk; ``device`` (``None`` means
    ``cuda``) is where the run happens."""
    from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule
    from climsr_tpu_torch.training.callbacks import build_callbacks
    from climsr_tpu_torch.training.loop import Trainer
    from climsr_tpu_torch.utils.core import extras, print_config

    dev = resolve_device(device)
    extras(ignore_warnings=bool(cfg.get("ignore_warnings", True)))  # reference utils.py:17
    if cfg.get("print_config", True):
        print_config(cfg)

    training_cfg = from_dict(TrainingConfig, cfg.get("training")) or TrainingConfig()
    trainer_cfg = from_dict(TrainerConfig, cfg.get("trainer")) or TrainerConfig()
    # the profiler config group maps onto the trainer flag, as the
    # reference's hydra profiler group -> pl.Trainer(profiler=...)
    prof = cfg.get("profiler")
    if prof and not trainer_cfg.profiler:
        trainer_cfg.profiler = prof.get("name") if isinstance(prof, dict) else str(prof)
    task_cfg = from_dict(TaskConfig, _flatten_task_cfg(cfg.get("task"))) or TaskConfig()
    data_cfg = from_dict(SuperResolutionDataConfig, (cfg.get("datamodule") or {}).get("cfg"))
    if data_cfg is None:
        raise ConfigError("config group 'datamodule' resolved to null — select datamodule=<name>")
    generator_cfg = from_dict(GeneratorConfig, cfg.get("generator"))
    if generator_cfg is None:
        raise ConfigError("config group 'generator' resolved to null — select generator=<name>")
    discriminator_cfg = from_dict(DiscriminatorConfig, cfg.get("discriminator"))
    generator_cfg = infer_generator_config(generator_cfg, data_cfg)

    optimizers = {
        key: from_dict(OptimizerConfig, (cfg.get("optimizers") or {}).get(key))
        for key in ("generator_optimizer", "discriminator_optimizer")
    }
    schedulers = {
        key: from_dict(SchedulerConfig, (cfg.get("schedulers") or {}).get(key))
        for key in ("generator_scheduler", "discriminator_scheduler")
    }

    import random

    import numpy as np

    random.seed(training_cfg.seed)
    np.random.seed(training_cfg.seed)

    if datamodule is None:
        datamodule = SuperResolutionDataModule(data_cfg)

    # every rank writes into (and reads) rank 0's timestamped directory
    run_dir = (
        Path(training_cfg.output_dir) / "outputs" / "runs" / training_cfg.generator_type
        / broadcast_string(time.strftime("%Y-%m-%d_%H-%M-%S"))
    )
    callback_names = cfg.get("callbacks")
    if isinstance(callback_names, str):
        callback_names = [callback_names]  # callbacks=log_images (single select)
    elif isinstance(callback_names, dict):
        callback_names = list(callback_names)
    callbacks = build_callbacks(callback_names)
    if report_cb is not None:
        callbacks.append(_ReportCallback(report_cb, training_cfg.optimized_metric or "hp_metric"))
    trainer = Trainer(
        datamodule=datamodule,
        generator_cfg=generator_cfg,
        task_cfg=task_cfg,
        trainer_cfg=trainer_cfg,
        training_cfg=training_cfg,
        discriminator_cfg=discriminator_cfg,
        optimizers=optimizers,
        schedulers=schedulers,
        workdir=run_dir,
        config_snapshot=cfg,
        callbacks=callbacks,
        logger_cfg=cfg.get("logger"),
        device=dev,
    )

    last_val: Dict[str, float] = {}
    try:
        if training_cfg.lr_find_only:
            # reference cli/train.py:98-109: the LR range test, report, exit
            from climsr_tpu_torch.training.lr_finder import lr_range_test

            suggestion, _ = lr_range_test(trainer)
            logger.info("LR finder done; suggestion=%.3g (lr_find.csv in %s)", suggestion, trainer.workdir)
            return suggestion
        if training_cfg.run_fit:
            last_val = trainer.fit()
        # skip the test phase when evicted: the SIGTERM grace window is for
        # the preemption checkpoint, not a full test pass
        if training_cfg.run_test_after_fit and not trainer.preempted:
            trainer.test()
    finally:
        trainer.close()

    if training_cfg.optimized_metric:
        return last_val.get(training_cfg.optimized_metric)
    return last_val.get("hp_metric")


def run_hparams_search(cfg: Dict[str, Any], overrides: List[str], device: DeviceLike = None,
                       tables=None) -> Optional[float]:
    """The sweep of ``cfg["hparams_search"]`` (reference: hydra ``-m`` with the
    Optuna sweeper; JAX ``climsr_tpu/cli/train.py:196-217``): each trial
    composes ``overrides`` (less the ``hparams_search`` ones, plus the
    trial's choices and ``training.optimized_metric``) and :func:`run` s it,
    its validations reported to the median pruner. Trials and ``best.yaml``
    land in ``<training.output_dir>/hparams_search``. ``tables`` (the
    synthetic set's in-memory tables) builds each trial's datamodule from
    them instead of the feather files. Returns the best trial's value."""
    from climsr_tpu_torch.training.hparams_search import run_search

    search_cfg = cfg["hparams_search"]
    metric = search_cfg.get("optimized_metric", "val/rmse")
    base = [o for o in overrides if not o.startswith("hparams_search")]
    base.append(f"training.optimized_metric={metric}")

    def objective(trial_overrides: List[str], report) -> Optional[float]:
        trial_cfg = compose(default_config_dir(), "config", trial_overrides)
        trial_cfg["print_config"] = False
        datamodule = None
        if tables is not None:
            from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule

            data_cfg = from_dict(SuperResolutionDataConfig, trial_cfg["datamodule"]["cfg"])
            datamodule = SuperResolutionDataModule(data_cfg, tables=tables)
        return run(trial_cfg, report_cb=report, datamodule=datamodule, device=device)

    best, _ = run_search(base, search_cfg, objective,
                         output_dir=str((cfg.get("training") or {}).get("output_dir", ".")) + "/hparams_search")
    return best.value if best else None


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> Optional[float]:
    """Compose ``conf/config.yaml`` with ``argv`` (default ``sys.argv[1:]``)
    and :func:`run` it. A leading ``--device=<name>`` sets ``device``."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    overrides = list(argv if argv is not None else sys.argv[1:])
    while overrides and overrides[0].startswith("--device="):
        device = overrides.pop(0).split("=", 1)[1]
    dev = resolve_device(device)
    init_from_env(dev)
    if dev.type == "cuda" and world()[1] > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = compose(default_config_dir(), "config", overrides)
    n = (cfg.get("trainer") or {}).get("num_devices")
    if n is not None and int(n) > 1 and world()[1] == 1:
        spawn("climsr_tpu_torch.cli.train:main_rank", int(n), {"argv": overrides, "device": dev.type},
              backend="nccl" if dev.type == "cuda" else "gloo")
        return None
    search_cfg = cfg.get("hparams_search")
    if isinstance(search_cfg, dict) and search_cfg.get("search_space"):
        return run_hparams_search(cfg, overrides, dev)
    return run(cfg, device=dev)


def main_rank(argv: List[str], device: str) -> None:
    """One rank of a run that :func:`main` started (on its card under NCCL)."""
    main(argv, device=device)


if __name__ == "__main__":
    main()
