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
composed config is the JAX package's. ``hparams_search`` and
``training.lr_find_only`` raise (``ROADMAP.md``, queue 1, item 9).
"""
from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

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

logger = logging.getLogger(__name__)

_SERVICES = "ROADMAP.md, queue 1, item 9: remaining services"


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
    if training_cfg.lr_find_only:
        raise NotImplementedError(f"training.lr_find_only (the LR range test) is not ported yet: {_SERVICES}")
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

    run_dir = (
        Path(training_cfg.output_dir) / "outputs" / "runs" / training_cfg.generator_type
        / time.strftime("%Y-%m-%d_%H-%M-%S")
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


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> Optional[float]:
    """Compose ``conf/config.yaml`` with ``argv`` (default ``sys.argv[1:]``)
    and :func:`run` it. A leading ``--device=<name>`` sets ``device``."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    overrides = list(argv if argv is not None else sys.argv[1:])
    while overrides and overrides[0].startswith("--device="):
        device = overrides.pop(0).split("=", 1)[1]
    dev = resolve_device(device)
    cfg = compose(default_config_dir(), "config", overrides)
    search_cfg = cfg.get("hparams_search")
    if isinstance(search_cfg, dict) and search_cfg.get("search_space"):
        raise NotImplementedError(f"hparams_search (the hyperparameter sweep) is not ported yet: {_SERVICES}")
    return run(cfg, device=dev)


if __name__ == "__main__":
    main()
