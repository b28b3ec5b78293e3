"""A cell is data: a configuration file, a traffic file, limits and a
``workloads`` entry make a runnable cell, with no code added."""
import json

import pytest
from perfbench_support import run_cell, tiny_bench  # noqa: F401 (a fixture)

from perfbench import harness


@pytest.mark.parametrize("traffic, entry_metrics", [
    ("tiny-pretrain", {"train_samples_per_s", "train_step_p90_ms", "setup_s"}),
    ("tiny-sweep", {"sweep_months_per_s", "setup_s"}),
])
def test_new_cell_from_data_files_alone(tiny_bench, traffic, entry_metrics):
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    mix = json.loads((tiny_bench / "traffic" / f"{traffic}.json").read_text())
    key = "batch_size" if mix["entry"] == "train" else "checked_per_sweep"
    mix[key] = 2 if mix["entry"] == "train" else 1
    (tiny_bench / "traffic" / "added-mix.json").write_text(json.dumps(mix))
    (tiny_bench / "limits" / "tiny.added.json").write_text(
        (tiny_bench / "limits" / f"tiny.{traffic.split('-')[1]}.json").read_text())
    spec["workloads"].append({"name": "tiny.added", "config": "tiny", "traffic": "added-mix", "chips": 1,
                              "why": "added by data files alone"})
    for m in spec["end_to_end"]:
        if "workloads" in m and set(m["workloads"]) & {f"tiny.{traffic.split('-')[1]}"}:
            m["workloads"].append("tiny.added")
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))

    cell, out, line = run_cell(tiny_bench, "tiny.added")
    assert set(line["metrics"]) == entry_metrics
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)


def test_metric_without_workloads_applies_to_every_cell(tiny_bench):
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    cell = harness.load_cell("tiny.sweep", tiny_bench / "BENCHMARK.json", tiny_bench)
    assert [m["name"] for m in cell.end_to_end] == ["sweep_months_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["sweep_mfu"]
    assert any("workloads" not in m for m in spec["end_to_end"])


def test_traced_line_carries_device_and_breakdown(tiny_bench):
    _, out, line = run_cell(tiny_bench, "tiny.pretrain", trace=True)
    assert set(line["metrics"]) == {"train_mfu"}
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_limits_name_the_compared_numbers(tiny_bench):
    (tiny_bench / "limits" / "tiny.sweep.json").write_text(json.dumps({"sweep_gap": 1.0}))
    cell = harness.load_cell("tiny.sweep", tiny_bench / "BENCHMARK.json", tiny_bench)
    assert set(harness.judge(cell, {"sweep_gap": 0.0, "nan_mismatch": 3.0})) == {"sweep_gap"}
    (tiny_bench / "limits" / "tiny.sweep.json").write_text(json.dumps({"sweep_gap": 1.0, "unread": 1.0}))
    cell = harness.load_cell("tiny.sweep", tiny_bench / "BENCHMARK.json", tiny_bench)
    with pytest.raises(KeyError):
        harness.judge(cell, {"sweep_gap": 0.0, "nan_mismatch": 0.0})
