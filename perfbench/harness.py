"""One run of one cell: find its files by name, drive its entry, read its
metrics, and build the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<config>.json`` (the model's sizes, its source and
what was cut), the traffic ``traffic/<traffic>.json``, whose ``entry`` names
the module under ``entries/`` that drives the port, and the correctness
limits ``limits/<cell>.json``. A per-layer metric is read by
``metrics/<name>.py``'s ``read(outcome, cell)``, which returns None where it
finds nothing to read; the metric is then left out of the line. An entry reads
every number its check can compare; the cell's limits file names the numbers
it compares and their limits.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from perfbench.trace import TraceSummary

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


@dataclass
class Outcome:
    """What an entry hands back: the end-to-end values it measured, the
    numbers its check compared (by name), and what the readers read."""

    kind: str
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]  # every number the check read; the limits file names those compared
    window_s: float = 0.0  # the untraced window's wall
    flops: float = 0.0  # the model's operations in that window
    trace: Optional[TraceSummary] = None
    notes: Dict[str, object] = field(default_factory=dict)


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, bench: Optional[Path] = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json`` at the
    checkout's root; a configuration's ``file`` is relative to its directory)
    with its traffic and limits under ``base``."""
    bench = bench or ROOT / "BENCHMARK.json"
    spec = json.loads(bench.read_text())
    works = [w for w in spec["workloads"] if w["name"] == name]
    if len(works) != 1:
        raise KeyError(f"no workload {name!r} in {bench}")
    work = works[0]
    (conf,) = [c for c in spec["configs"] if c["name"] == work["config"]]
    config = json.loads((bench.parent / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{work['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    return Cell(name, config, traffic, int(work["chips"]), _for_cell(spec["end_to_end"], name),
                _for_cell(spec["per_layer"], name), limits)


def reader(name: str):
    """``metrics/<name>.py`` as a module (metric names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_entry(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float,
              control: bool = False) -> Outcome:
    entry = importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")
    return entry.run(cell, seed, seconds, trace, device, start, control)


def judge(cell: Cell, readings: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number the cell compares (those its limits file names) beside its
    limit; a limit whose number the entry did not read raises."""
    missing = sorted(set(cell.limits) - set(readings))
    if missing:
        raise KeyError(f"the run read no {missing} for limits/{cell.name}.json")
    return {k: {"value": readings[k], "limit": cell.limits[k]} for k in cell.limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(cell: Cell, out: Outcome, trace: bool, device_kind: str, count: int,
                platform: str = "gpu") -> dict:
    checks = judge(cell, out.checks)
    correct = passed(checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"]).read(out, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": platform, "kind": device_kind, "count": count, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in out.trace.device_ops],
                             "idle_gaps": [list(x) for x in out.trace.idle_gaps]}
    line["checks"] = checks
    return line
