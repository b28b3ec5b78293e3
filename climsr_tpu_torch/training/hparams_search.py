# -*- coding: utf-8 -*-
"""Hyperparameter search (the reference's Optuna sweeper, self-contained):
the port of ``climsr_tpu.training.hparams_search``, copied as it is but for
``best.yaml``, written with the port's ``config.yaml_subset.dump_yaml``
(PyYAML may be missing where the port runs) in a form ``load_yaml`` reads back.

Parity: ``conf/hparams_search/srcnn_optuna.yaml`` — categorical search space
over training/datamodule knobs, objective = the metric the train CLI returns
(``optimized_metric``, usually val/rmse), direction minimize, n_trials.

Optuna is not a dependency, so the module implements:

- ``random`` sampling, and
- ``tpe`` — a categorical Tree-of-Parzen-Estimators-style sampler: after
  ``n_startup_trials`` random trials, the trials are split at the ``gamma``
  quantile into good/bad sets and each categorical choice is sampled
  proportionally to ``(count_good + 1) / (count_bad + 1)`` — the standard TPE
  ratio rule specialized to categorical spaces (all of the reference's search
  dimensions are categorical),
- **median pruning** (optuna ``MedianPruner`` semantics): the objective may
  report intermediate values (one per validation); once at least
  ``n_startup_trials`` other trials have a value at the same report index, a
  trial whose latest value is worse than their median raises
  :class:`TrialPruned` and is recorded with state ``PRUNED``,
- **failed-trial tolerance**: an objective exception marks the trial
  ``FAILED`` (value None) and the sweep continues,
- **resume**: trials (params, value, state, intermediate reports) persist to
  ``trials.csv`` after every trial; re-running ``run_search`` with the same
  ``output_dir`` reloads them, continues numbering, and feeds the full
  history to the sampler and pruner.

Results land in ``<output_dir>/hparams_search/trials.csv`` + ``best.yaml``.
"""
from __future__ import annotations

import csv
import logging
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from climsr_tpu_torch.config.yaml_subset import dump_yaml

logger = logging.getLogger(__name__)


@dataclass
class SearchSpace:
    """name -> list of categorical choices."""

    dimensions: Dict[str, List[Any]]

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "SearchSpace":
        dims = {}
        for key, spec in (cfg or {}).items():
            if isinstance(spec, dict) and spec.get("type") == "categorical":
                dims[key] = list(spec["choices"])
            elif isinstance(spec, list):
                dims[key] = list(spec)
            else:
                raise ValueError(f"Unsupported search dimension {key}: {spec}")
        return cls(dims)


class TrialPruned(Exception):
    """Raised by a trial's report() when the pruner cuts it short."""


@dataclass
class Trial:
    number: int
    params: Dict[str, Any]
    value: Optional[float] = None
    state: str = "COMPLETE"  # COMPLETE | FAILED | PRUNED
    intermediate: List[float] = field(default_factory=list)


class MedianPruner:
    """optuna.pruners.MedianPruner semantics for sign-normalized (minimize)
    values: prune when the trial's latest report is worse than the median of
    every other trial's report at the same index."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, trials: Sequence[Trial], trial: Trial) -> bool:
        idx = len(trial.intermediate) - 1
        if idx < self.n_warmup_steps:
            return False
        peers = [
            t.intermediate[idx]
            for t in trials
            if t is not trial and t.state != "FAILED" and len(t.intermediate) > idx
        ]
        if len(peers) < self.n_startup_trials:
            return False
        return trial.intermediate[-1] > float(np.median(peers))


class NopPruner:
    def should_prune(self, trials, trial) -> bool:
        return False


class CategoricalTPESampler:
    def __init__(self, space: SearchSpace, seed: int = 42, n_startup_trials: int = 10, gamma: float = 0.25):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma

    def suggest(self, history: Sequence[Trial]) -> Dict[str, Any]:
        # Optuna's consider_pruned_trials=False default: a PRUNED trial's
        # value is an early-epoch intermediate, not comparable to peers'
        # final values — feeding it to the good/bad split would bias every
        # later suggestion toward epoch-0 noise (see run_search's matching
        # exclusion from `best`).
        completed = [
            t
            for t in history
            if t.state == "COMPLETE" and t.value is not None and math.isfinite(t.value)
        ]
        if len(completed) < self.n_startup_trials:
            return {k: self._choice(v) for k, v in self.space.dimensions.items()}
        ranked = sorted(completed, key=lambda t: t.value)
        n_good = max(1, int(len(ranked) * self.gamma))
        good, bad = ranked[:n_good], ranked[n_good:]
        params = {}
        for key, choices in self.space.dimensions.items():
            weights = []
            for choice in choices:
                cg = sum(1 for t in good if _eq(t.params.get(key), choice))
                cb = sum(1 for t in bad if _eq(t.params.get(key), choice))
                weights.append((cg + 1.0) / (cb + 1.0))
            w = np.asarray(weights) / np.sum(weights)
            params[key] = choices[int(self.rng.choice(len(choices), p=w))]
        return params

    def _choice(self, choices: List[Any]) -> Any:
        return choices[int(self.rng.integers(len(choices)))]


class RandomSampler(CategoricalTPESampler):
    def suggest(self, history: Sequence[Trial]) -> Dict[str, Any]:
        return {k: self._choice(v) for k, v in self.space.dimensions.items()}


def _eq(a, b) -> bool:
    return a == b


def _to_override(key: str, value: Any) -> str:
    import json

    # JSON is a YAML subset, so the CLI's yaml-based override parser reads it back
    return f"{key}={json.dumps(value)}"


def run_search(
    base_overrides: List[str],
    search_cfg: Dict[str, Any],
    objective: Callable[[List[str]], Optional[float]],
    output_dir: str = "hparams_search",
) -> Tuple[Optional[Trial], List[Trial]]:
    """Run the sweep; ``objective(overrides) -> metric`` is usually the port's
    ``cli.train.run`` on the composed trial config."""
    space = SearchSpace.from_config(search_cfg.get("search_space"))
    n_trials = int(search_cfg.get("n_trials", 20))
    direction = search_cfg.get("direction", "minimize")
    sampler_name = (search_cfg.get("sampler") or {}).get("name", "tpe") if isinstance(
        search_cfg.get("sampler"), dict
    ) else search_cfg.get("sampler", "tpe")
    seed = int((search_cfg.get("sampler") or {}).get("seed", 42)) if isinstance(search_cfg.get("sampler"), dict) else 42
    sampler_cls = CategoricalTPESampler if sampler_name == "tpe" else RandomSampler
    sampler = sampler_cls(space, seed=seed, n_startup_trials=int(
        (search_cfg.get("sampler") or {}).get("n_startup_trials", 10)
    ) if isinstance(search_cfg.get("sampler"), dict) else 10)

    pruner_cfg = search_cfg.get("pruner")
    if isinstance(pruner_cfg, dict) and pruner_cfg.get("name", "median") == "median":
        pruner = MedianPruner(
            n_startup_trials=int(pruner_cfg.get("n_startup_trials", 5)),
            n_warmup_steps=int(pruner_cfg.get("n_warmup_steps", 0)),
        )
    elif pruner_cfg in ("median", True):
        pruner = MedianPruner()
    else:
        pruner = NopPruner()

    sign = 1.0 if direction == "minimize" else -1.0
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "trials.csv"

    trials: List[Trial] = []
    if search_cfg.get("resume", True) and csv_path.exists():
        trials = _load_trials(csv_path, sign)
        logger.info("Resuming sweep: %d prior trials from %s", len(trials), csv_path)

    # Optuna semantics: only COMPLETE trials compete for best — a PRUNED
    # trial's value is an early-epoch intermediate, not comparable to peers'
    # final values.
    best: Optional[Trial] = None
    for t in trials:
        if t.state == "COMPLETE" and t.value is not None and (best is None or t.value < best.value):
            best = t

    for i in range(len(trials), n_trials):
        params = sampler.suggest(trials)
        overrides = list(base_overrides) + [_to_override(k, v) for k, v in params.items()]
        logger.info("Trial %d/%d: %s", i + 1, n_trials, params)
        trial = Trial(number=i, params=params)
        trials.append(trial)

        def report(step: int, raw_value: float) -> None:
            trial.intermediate.append(sign * float(raw_value))
            if pruner.should_prune(trials, trial):
                raise TrialPruned(f"trial {trial.number} pruned at report {len(trial.intermediate)}")

        try:
            raw = _call_objective(objective, overrides, report)
            trial.value = sign * float(raw) if raw is not None else None
        except TrialPruned as e:
            logger.info("%s", e)
            trial.state = "PRUNED"
            trial.value = trial.intermediate[-1] if trial.intermediate else None
        except Exception:
            logger.exception("Trial %d failed", i)
            trial.state = "FAILED"
            trial.value = None
        if trial.state == "COMPLETE" and trial.value is not None and (best is None or trial.value < best.value):
            best = trial
            (out_dir / "best.yaml").write_text(dump_yaml({"value": sign * best.value, "params": best.params}))
        _write_trials(csv_path, trials, sign)
    if best:
        logger.info("Best trial: %s -> %.5f", best.params, sign * best.value)
    return best, trials


def _call_objective(objective, overrides: List[str], report) -> Optional[float]:
    """Call with the report hook when the objective accepts it (2-arg form)."""
    import inspect

    try:
        n_params = len(inspect.signature(objective).parameters)
    except (TypeError, ValueError):
        n_params = 1
    if n_params >= 2:
        return objective(overrides, report)
    return objective(overrides)


def _write_trials(path: Path, trials: List[Trial], sign: float) -> None:
    import json

    keys = sorted({k for t in trials for k in t.params})
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["number", "value", "state", "params_json", "intermediate_json"] + keys)
        for t in trials:
            writer.writerow(
                [
                    t.number,
                    sign * t.value if t.value is not None else "",
                    t.state,
                    json.dumps(t.params),
                    json.dumps([sign * v for v in t.intermediate]),
                ]
                + [t.params.get(k) for k in keys]
            )


def _load_trials(path: Path, sign: float) -> List[Trial]:
    """Reload persisted trials for sweep resume (inverse of _write_trials).

    The CSV stores user-facing values (direction sign undone); multiplying by
    ``sign`` restores minimize-space. A sweep must be resumed with the same
    ``direction`` it started with (as with Optuna storages).
    """
    import json

    out: List[Trial] = []
    try:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                value = sign * float(row["value"]) if row.get("value") else None
                out.append(
                    Trial(
                        number=int(row["number"]),
                        params=json.loads(row["params_json"]),
                        value=value,
                        state=row.get("state", "COMPLETE"),
                        intermediate=[sign * v for v in json.loads(row.get("intermediate_json") or "[]")],
                    )
                )
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
        # unreadable / legacy-format trials.csv: don't abort the sweep — the
        # unreadable history can't seed the sampler anyway, so start fresh
        # (the first _write_trials overwrites the file in the current format)
        logger.warning("Could not parse %s for resume (%s); starting a fresh sweep", path, e)
        return []
    return out
