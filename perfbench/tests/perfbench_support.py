"""Helpers of the harness's tests: the tiny CPU benchmark under ``data/`` and a run of one of its cells."""
import shutil
import time
from pathlib import Path

import pytest
import torch

DATA = Path(__file__).resolve().parent / "data"


def cuda_or_skip() -> torch.device:
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture()
def tiny_bench(tmp_path):
    """A copy of the tiny test benchmark that a test may add files to."""
    dst = tmp_path / "bench"
    shutil.copytree(DATA, dst)
    return dst


def run_cell(bench: Path, name: str, seed: int = 11, seconds: float = 0.5, trace: bool = False,
             control: bool = False):
    """The harness's run of ``name`` on the CPU, past its look for a card."""
    from perfbench import harness

    cell = harness.load_cell(name, bench / "BENCHMARK.json", bench)
    out = harness.run_entry(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), control)
    return cell, out, harness.result_line(cell, out, trace, "cpu", 1, platform="cpu") if not control else None

