"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per", "nf", "gc")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and (ROOT / p).is_dir() for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51 and (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
    for key, allowed in ENTRY_KEYS.items():
        for entry in SPEC[key]:
            assert set(entry) <= allowed and NAME.match(entry["name"]), entry


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_configs():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files)) and 1 <= len(files) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(w in k for k in c["reduced"] for w in WIDTHS) and not any(
            k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_workloads():
    work = SPEC["workloads"]
    assert 1 <= len(work) <= 24
    four = sum(w["chips"] == 4 for w in work)
    assert all(w["chips"] in (1, 4) for w in work) and four <= max(1, len(work) // 4)
    for w in work:
        assert line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_and_its_reader(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moves = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]]
    assert len(moves) == 1
    for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
        assert "workloads" not in moves[0] or cell in moves[0]["workloads"]
    mod = harness.reader(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        layers = {m["layer"] for m in SPEC["per_layer"]}
        assert all(line(x) for x in layers)
