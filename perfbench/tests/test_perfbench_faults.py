"""A run past the harness's look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have, and
true without one. The tiny cells' limits sit between their sound runs'
readings on the CPU (pre-training: loss 1.6e-4, first output 0.011, change
0.047 over 12 seeds; GAN, 6 seeds: first losses 1.9e-3, first output 0.013,
the worse model's median leaf's change 0.095, G's (D's 0.012); sweep 1.4e-3
over 6) and the faults' and controls' (GAN: D's optimizer frozen, D's
median change 1; perceptual or adversarial term dropped, first losses
0.24-0.34)."""
import pytest
from perfbench_support import run_cell, tiny_bench  # noqa: F401 (a fixture)

import faults


@pytest.mark.parametrize("cell", ["tiny.pretrain", "tiny.gan", "tiny.sweep"])
def test_sound_run_is_correct(tiny_bench, cell):
    assert run_cell(tiny_bench, cell, seed=2 ** 31 + 17)[2]["correct"] is True


@pytest.mark.parametrize("cell, fault", [
    ("tiny.pretrain", "frozen_state"),
    ("tiny.pretrain", "half_batch"),
    ("tiny.gan", "frozen_state"),
    ("tiny.gan", "half_batch"),
    ("tiny.gan", "frozen_d_state"),
    ("tiny.gan", "no_perceptual"),
    ("tiny.gan", "no_adversarial"),
    ("tiny.sweep", "altered_answer"),
    ("tiny.sweep", "dropped_month"),
])
def test_fault_is_not_correct(tiny_bench, cell, fault):
    with getattr(faults, fault)():
        line = run_cell(tiny_bench, cell, seed=2 ** 31 + 17)[2]
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["tiny.pretrain", "tiny.sweep"])
def test_control_is_not_correct(tiny_bench, cell):
    from perfbench import harness

    c, out, _ = run_cell(tiny_bench, cell, seed=2 ** 31 + 17, control=True)
    assert not harness.passed(harness.judge(c, out.checks))
