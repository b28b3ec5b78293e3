"""Each cell's control on the card, at the cell's own size: the plain
reference in float8 put in the program's place must come out not correct on
three seeds. Run on a machine with a card:
``python -m pytest perfbench/tests/test_perfbench_control.py -m cuda``."""
import json
import time
from pathlib import Path

import pytest
from perfbench_support import cuda_or_skip

from perfbench import harness

CELLS = [w["name"] for w in json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    device = cuda_or_skip()
    cell = harness.load_cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        out = harness.run_entry(cell, seed, 1.0, False, device, time.perf_counter(), control=True)
        checks = harness.judge(cell, out.checks)
        assert not harness.passed(checks), f"{name} seed {seed}: the control passed {checks}"
