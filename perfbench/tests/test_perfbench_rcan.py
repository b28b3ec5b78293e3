"""The RCAN cell: its routing, its counts against hand counts, its span
readings and metrics, and a CPU-sized copy of it run through the harness,
sound, with each RCAN fault, and as the control.

The tiny cell (2 groups x 3 RCABs x 16 features, reduction 4, batch 4 of
32-px tiles) is added at test time to a copy of the tiny test benchmark; its
limits sit between its sound runs' readings on the CPU (first output <=
0.0083, change <= 0.11, the attentions' gradient <= 0.068 over 4 seeds) and
the faults' and the control's (no attention: change 1; the pool over one row:
the attentions' gradient 0.49-0.53; control: first output 0.14-0.20)."""
import json
import math

import pytest
import torch
from perfbench_support import run_cell, tiny_bench  # noqa: F401 (a fixture)

import faults_rcan
from perfbench import harness
from perfbench.counts import rcan as counts
from perfbench.entries import train_rcan
from perfbench.reference import rcan as ref
from perfbench.spans import DeviceEvent, SpanPass

PUBLISHED = dict(name="rcan", n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16, in_channels=3,
                 out_channels=1, scaling_factor=4)
TINY = "tiny-rcan.pretrain"
SEED = 2 ** 31 + 17


@pytest.fixture()
def rcan_bench(tiny_bench):
    """The tiny benchmark with the tiny RCAN cell and its metrics added."""
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-rcan", "source": "a CPU-sized RCAN", "file": "configs/tiny-rcan.json",
                            "reduced": ["n_resgroups", "n_resblocks", "n_feats"], "why": "the harness's own tests"})
    spec["workloads"].append({"name": TINY, "config": "tiny-rcan", "traffic": "tiny-rcan-pretrain", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.pretrain" in m.get("workloads", []):
            m["workloads"].append(TINY)
    for name, better, layer in (("rcan_ca_fwd_pct", "lower", "model"), ("rcan_ca_roofline_pct", "higher", "kernels")):
        spec["per_layer"].append({"name": name, "unit": "%", "better": better, "source": "program_span",
                                  "layer": layer, "moves": "train_samples_per_s", "workloads": [TINY]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_bench


def test_the_cell_routes_to_the_rcan_entry():
    cell = harness.load_cell("rcan.pretrain-b96")
    assert cell.traffic["entry"] == "train_rcan" and cell.config["family"] == "rcan"
    assert cell.config["generator"] == PUBLISHED and cell.config["reduced"] == [] and cell.chips == 1
    assert (cell.traffic["experiment"], cell.traffic["batch_size"], cell.traffic["tiles"]) == ("rcan_pre_training", 96,
                                                                                                28800)
    names = [m["name"] for m in cell.per_layer]
    assert names == ["train_mfu", "train_device_idle_pct", "rcan_ca_fwd_pct", "rcan_ca_roofline_pct"]
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "train_step_p90_ms", "setup_s"}
    assert {"out1_gap", "move_gap"} <= set(cell.limits)


def test_counts_by_hand():
    conv = 9 * 64 * 64  # 36,864
    by_hand = (400 + 10 + 1) * conv + 9 * 3 * 64 + (4 * conv + 16 * conv) + 9 * 64 * 16 \
        + (81 * 3 * 64 + 64 * 32 + 25 * 32) * 16
    assert counts.macs_per_lr_px(PUBLISHED) == by_hand == 16_193_728
    assert counts.ca_macs_per_image(PUBLISHED) == 200 * 512
    # a step at batch 96 and LR 32: three forwards, 9.55 TFLOP
    assert counts.train_step_flops(PUBLISHED, 96, 32) == pytest.approx(
        3 * 2 * (96 * 32 * 32 * 16_193_728 + 96 * 200 * 512))
    assert counts.train_step_flops(PUBLISHED, 96, 32) == pytest.approx(9.55e12, rel=1e-3)
    # the 200 attentions of a forward at batch 96, bf16: 3 x 96 x 64 x 32 x 32 elements of 2 bytes each
    assert counts.ca_fwd_bytes(PUBLISHED, 96, 32, 32) == 200 * 3 * 96 * 64 * 1024 * 2
    small = dict(PUBLISHED, n_resgroups=1, n_resblocks=1, n_feats=8, reduction=4, scaling_factor=2)
    assert counts.macs_per_lr_px(small) == 9 * 8 * 8 * 4 + 9 * 3 * 8 + 4 * 9 * 8 * 8 + 9 * 8 * 4 \
        + (81 * 3 * 64 + 64 * 32 + 25 * 32) * 4


def test_reference_names_are_the_ports_at_the_published_widths():
    from climsr_tpu_torch.models.rcan import RCAN

    with torch.device("meta"):
        port = RCAN(**{k: v for k, v in PUBLISHED.items() if k != "name"})
    shapes = ref.param_shapes(PUBLISHED)
    assert [(k, tuple(v.shape)) for k, v in port.state_dict().items()] == shapes and len(shapes) == 1636
    assert sum(math.prod(s) for _, s in shapes) == pytest.approx(15.6e6, rel=0.01)


def _pass(device=True):
    """A forward span (0-50 ms) holding two attention spans, and device events
    launched inside them, inside the forward alone, and outside it."""
    from climsr_tpu_torch.utils.profiling import Span

    ms = 1_000_000
    spans = [Span(train_rcan.FORWARD, 1, 0, 50 * ms, None, None, 0),
             Span(train_rcan.CA, 1, 10 * ms, 20 * ms, 0, 0, 1), Span(train_rcan.CA, 1, 30 * ms, 40 * ms, 0, 1, 2)]
    events = [DeviceEvent("conv", "kernel", 12 * ms, 20 * ms, 5 * ms), DeviceEvent("pool", "kernel", 20 * ms, 23 * ms, 11 * ms),
              DeviceEvent("mul", "kernel", 40 * ms, 41 * ms, 35 * ms), DeviceEvent("opt", "kernel", 60 * ms, 70 * ms, 55 * ms)]
    return SpanPass((0, 100 * ms), events, spans, {train_rcan.CA_CALLS: 2}, 1, device=device)


def test_span_readings_and_the_metrics_that_read_them(rcan_bench):
    got = train_rcan.ca_readings(_pass())
    assert got == {"ca_spans": 2, "ca_calls": 2, "forward_spans": 1, "ca_device_s": pytest.approx(0.004),
                   "forward_device_s": pytest.approx(0.012)}
    assert train_rcan.ca_readings(_pass(device=False)) == {"ca_spans": 2, "ca_calls": 2, "forward_spans": 1}
    assert train_rcan.ca_readings(None) == {}
    cell = harness.load_cell("rcan.pretrain-b96")
    out = harness.Outcome("train", {}, 0, 0, 0, {}, notes={"rcan_ca": dict(got, ca_spans=400)})
    assert harness.reader("rcan_ca_fwd_pct").read(out, cell) == pytest.approx(100 * 4 / 12)
    # two forwards' attentions, 2 x 7.55 GB at 3.35 TB/s, over 4 ms
    want = 100 * 2 * counts.ca_fwd_bytes(PUBLISHED, 96, 32, 32) / 3.35e12 / 0.004
    assert harness.reader("rcan_ca_roofline_pct").read(out, cell) == pytest.approx(want)
    for notes in ({}, {"rcan_ca": {}}, {"rcan_ca": {"ca_spans": 0, "ca_calls": 0, "forward_spans": 20,
                                                    "ca_device_s": 0.0, "forward_device_s": 1.0}}):
        bare = harness.Outcome("train", {}, 0, 0, 0, {}, notes=notes)  # a program without the spans
        assert harness.reader("rcan_ca_fwd_pct").read(bare, cell) is None
        assert harness.reader("rcan_ca_roofline_pct").read(bare, cell) is None


def test_sound_run_is_correct_and_traced_records_the_attention(rcan_bench):
    cell, out, line = run_cell(rcan_bench, TINY, seed=SEED, trace=True)
    assert line["correct"] is True and set(line["checks"]) == set(cell.limits)
    steps = cell.traffic["traced_steps"]
    assert out.notes["rcan_ca"] == {"ca_spans": 6 * steps, "ca_calls": 6 * steps, "forward_spans": steps}
    assert set(line["metrics"]) == {"train_mfu"}  # the span metrics read device time, which the CPU has not


def test_the_window_is_at_least_one_whole_epoch(rcan_bench):
    """However short ``--seconds`` is, the window runs the traffic's
    ``window_epochs`` whole epochs (the tiny cell's: 24 tiles at batch 4)."""
    cell, out, line = run_cell(rcan_bench, TINY, seed=SEED, seconds=0.0)
    per_epoch = cell.traffic["tiles"] // cell.traffic["batch_size"]
    assert out.notes["steps"] == cell.traffic["window_epochs"] * per_epoch == 6
    assert line["attempted"] == 6 and line["correct"] is True


@pytest.mark.parametrize("fault", ["no_channel_attention", "pool_one_row"])
def test_fault_is_not_correct(rcan_bench, fault):
    with getattr(faults_rcan, fault)():
        line = run_cell(rcan_bench, TINY, seed=SEED)[2]
    assert line["correct"] is False


def test_control_is_not_correct(rcan_bench):
    cell, out, _ = run_cell(rcan_bench, TINY, seed=SEED, control=True)
    assert not harness.passed(harness.judge(cell, out.checks))


@pytest.mark.parametrize("override", ["generator.reduction=8", "training.batch_size=2", "trainer.precision=fp32",
                                      "optimizers.generator_optimizer.weight_decay=0.0"])
def test_a_departing_composition_raises(rcan_bench, override):
    mix = json.loads((rcan_bench / "traffic" / "tiny-rcan-pretrain.json").read_text())
    mix["overrides"].append(override)
    (rcan_bench / "traffic" / "tiny-rcan-pretrain.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="departs from the cell"):
        run_cell(rcan_bench, TINY, seed=SEED)
