# -*- coding: utf-8 -*-
"""Experiment logging: CSV + TensorBoard, rank 0 only. The port of ``climsr_tpu.utils.logging``.

Covers the reference's logger config group (``conf/logger/*``): ``metrics.csv``
always; TensorBoard where ``tensorboardX`` or ``torch.utils.tensorboard``
imports (else CSV only, as the JAX package falls back); wandb/neptune/comet/
mlflow map to the same MetricLogger interface and are gated on their packages
being importable. Nothing here touches a device.
"""
from __future__ import annotations

import csv
import logging
import os
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def is_process_zero() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    """Fan-out logger: tensorboard + csv (+ optional third-party trackers);
    no-op on non-zero processes."""

    @classmethod
    def from_config(cls, log_dir: os.PathLike, spec) -> "MetricLogger":
        """Build from the ``logger`` config group (``conf/logger/*``).

        ``spec`` is the composed group value: a name string, a dict with
        ``name`` (and extras like wandb's ``project``), or ``many_loggers``
        with a ``loggers`` list. Third-party trackers (wandb/mlflow/neptune/
        comet) are attempted by import and fall back to tensorboard+csv with
        a warning when their package is absent.
        """
        if spec is None:
            return cls(log_dir)
        if isinstance(spec, str):
            spec = {"name": spec}
        names = [spec.get("name", "tensorboard")]
        if names == ["many_loggers"]:
            names = list(spec.get("loggers") or ["tensorboard", "csv"])
        third_party = [n for n in names if n in ("wandb", "mlflow", "neptune", "comet")]
        self = cls(
            log_dir,
            use_tensorboard="tensorboard" in names or bool(third_party),
            use_csv=True,  # metrics.csv is the canonical machine-readable record
        )
        for name in third_party:
            self._attach_third_party(name, spec)
        return self

    def _attach_third_party(self, name: str, spec) -> None:
        if not self.enabled:
            return
        try:
            if name == "wandb":
                import wandb

                run = wandb.init(project=spec.get("project", "climsr"), dir=str(self.log_dir), resume="allow")
                self._third_party.append(("wandb", run))
            elif name == "mlflow":
                import mlflow

                mlflow.set_experiment(spec.get("experiment_name", "climsr"))
                mlflow.start_run()
                self._third_party.append(("mlflow", mlflow))
            elif name == "neptune":
                import neptune

                run = neptune.init_run(
                    project=spec.get("project_name") or spec.get("project"),
                    name=spec.get("experiment_name", "climsr"),
                )
                self._third_party.append(("neptune", run))
            elif name == "comet":
                import comet_ml

                exp = comet_ml.Experiment(
                    project_name=spec.get("project_name", "climsr"),
                    workspace=spec.get("workspace"),
                )
                self._third_party.append(("comet", exp))
            else:
                raise ImportError(f"unknown third-party logger '{name}'")
        except Exception as e:
            logger.warning("logger '%s' unavailable (%s); falling back to tensorboard+csv", name, e)

    def __init__(self, log_dir: os.PathLike, use_tensorboard: bool = True, use_csv: bool = True):
        self.log_dir = Path(log_dir)
        self.enabled = is_process_zero()
        self._tb = None
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields = None
        self._third_party = []
        if not self.enabled:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        if use_tensorboard:
            self._tb = _summary_writer(self.log_dir / "tensorboard")
        if use_csv:
            self._csv_path = self.log_dir / "metrics.csv"

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        for kind, sink in self._third_party:
            if kind == "wandb":
                sink.log(scalars, step=step)
            elif kind == "mlflow":
                sink.log_metrics({k.replace("/", "."): v for k, v in scalars.items()}, step=step)
            elif kind == "neptune":
                for k, v in scalars.items():
                    sink[k].append(v, step=step)
            elif kind == "comet":
                sink.log_metrics(scalars, step=step)
        if hasattr(self, "_csv_path"):
            fields = ["step"] + sorted(scalars)
            if self._csv_writer is None:
                self._csv_file = open(self._csv_path, "a", newline="")
                self._csv_writer = csv.writer(self._csv_file)
            if fields != self._csv_fields:
                # heterogeneous rows (train vs val metrics): emit a fresh
                # header whenever the field set changes so every row is
                # self-describing (pandas reads it with header=0 per section)
                self._csv_writer.writerow(fields)
                self._csv_fields = fields
            self._csv_writer.writerow([step] + [scalars[k] for k in sorted(scalars)])
            self._csv_file.flush()

    def log_hyperparams(self, hparams: Dict, initial_hp_metric: Optional[float] = None) -> None:
        if not self.enabled or self._tb is None:
            return
        flat = {k: str(v) for k, v in hparams.items()}
        metrics = {"hp_metric": float(initial_hp_metric)} if initial_hp_metric is not None else {}
        try:
            self._tb.add_hparams(flat, metrics)
        except Exception:  # hparams logging is best-effort
            pass

    def log_image(self, tag: str, image, step: int) -> None:
        """image: HWC float in [0,1] or uint8."""
        if not self.enabled or self._tb is None:
            return
        self._tb.add_image(tag, image, step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._csv_file is not None:
            self._csv_file.close()
        for kind, sink in self._third_party:
            try:
                if kind == "wandb":
                    sink.finish()  # reference utils.py:116
                elif kind == "mlflow":
                    sink.end_run()
                elif kind == "neptune":
                    sink.stop()  # flush the background sync thread
                elif kind == "comet":
                    sink.end()
            except Exception:  # teardown is best-effort
                pass


def _summary_writer(log_dir: Path):
    """A TensorBoard writer from tensorboardX (the JAX package's), else from
    torch.utils.tensorboard, else None."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir=str(log_dir))
    except Exception as e:
        first = e
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=str(log_dir))
    except Exception as e:
        logger.warning("TensorBoard unavailable (%s; %s); falling back to CSV only", first, e)
        return None
