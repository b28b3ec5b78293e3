"""The RFB-ESRGAN cell: its routing, its counts against hand counts, its span
readings and metrics, and a CPU-sized copy of it run through the harness,
sound, with each RFB fault, and as the control.

The tiny cell (1 RRDB + 1 RRFDB at the published 64 features and growth 32,
batch 4 of 32-px tiles) is added at test time to a copy of the tiny test
benchmark; its limits sit between its sound runs' readings on the CPU (first
output <= 0.0144, the worst leaf's change <= 0.0553 over 6 seeds) and the
faults' and the control's (dilated convs at dilation 1: change 1.11-1.79; the
RFDBs' last dense feature left out: change 1.0; control: first output
0.126-0.149)."""
import json
import math

import pytest
import torch
from perfbench_support import run_cell, tiny_bench  # noqa: F401 (a fixture)

import faults_rfb
from perfbench import harness
from perfbench.counts import rfb_esrgan as counts
from perfbench.entries import train_rfb
from perfbench.reference import rfb_esrgan as ref
from perfbench.spans import DeviceEvent, SpanPass

PUBLISHED = dict(name="rfb_esrgan", num_rrdb_blocks=16, num_rrfdb_blocks=8, nf=64, gc=32, in_channels=3,
                 out_channels=1, scaling_factor=4)
TINY = "tiny-rfb.pretrain"
SEED = 2 ** 31 + 29


@pytest.fixture()
def rfb_bench(tiny_bench):
    """The tiny benchmark with the tiny RFB-ESRGAN cell and its metrics added."""
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-rfb", "source": "a CPU-sized RFB-ESRGAN", "file": "configs/tiny-rfb.json",
                            "reduced": ["num_rrdb_blocks", "num_rrfdb_blocks"], "why": "the harness's own tests"})
    spec["workloads"].append({"name": TINY, "config": "tiny-rfb", "traffic": "tiny-rfb-pretrain", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.pretrain" in m.get("workloads", []):
            m["workloads"].append(TINY)
    for name, better, layer in (("rfb_fwd_pct", "lower", "model"), ("rfb_roofline_pct", "higher", "kernels")):
        spec["per_layer"].append({"name": name, "unit": "%", "better": better, "source": "program_span",
                                  "layer": layer, "moves": "train_samples_per_s", "workloads": [TINY]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_bench


def test_the_cell_routes_to_the_rfb_entry():
    cell = harness.load_cell("rfb-esrgan.pretrain-b192")
    assert cell.traffic["entry"] == "train_rfb" and cell.config["family"] == "rfb_esrgan"
    assert cell.config["generator"] == PUBLISHED and cell.config["reduced"] == [] and cell.chips == 1
    assert (cell.traffic["experiment"], cell.traffic["batch_size"], cell.traffic["tiles"]) == (
        "esrgan_pre_training", 192, 28800)
    assert cell.traffic["overrides"] == ["generator=rfb_esrgan", "training.generator_type=rfb_esrgan"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["train_mfu", "train_device_idle_pct", "rdb_train_roofline_pct", "rfb_fwd_pct",
                     "rfb_roofline_pct"]
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "train_step_p90_ms", "setup_s"}
    assert {"out1_gap", "move_gap"} <= set(cell.limits)


def test_counts_by_hand():
    rdb = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)  # 239,616

    def rfb(cin, cout):
        c = cin // 4
        return (cin * cout + cin * c + 9 * c * c + 2 * (cin * c + 3 * c * c + 9 * c * c)
                + cin * (c // 2) + 3 * (c // 2) * (c // 4 * 3) + 3 * (c // 4 * 3) * c + 9 * c * c + 4 * c * cout)

    assert rfb(64, 64) == counts.rfb_macs_per_px(64, 64) == 23_392
    rfdb = sum(rfb(64 + m * 32, 32) for m in range(4)) + rfb(192, 64)
    assert rfdb == 395_248
    by_hand = (9 * 3 * 64 + 48 * rdb + 24 * rfdb + rfb(64, 64)  # conv1, Trunk_A, Trunk_RFB, the middle RFB
               + 4 * rfb(64, 64) + 4 * 9 * 64 * 256 + 16 * rfb(64, 64)  # the x4 stage: RFB at 2x2, conv, RFB at 4x4
               + 16 * (9 * 64 * 64 + 9 * 64))  # conv3 and conv4 at HR
    assert counts.macs_per_lr_px(PUBLISHED) == by_hand == 22_669_344
    # a step at batch 192 and LR 32: three forwards, 26.7 TFLOP
    assert counts.train_step_flops(PUBLISHED, 192, 32) == pytest.approx(3 * 2 * 192 * 32 * 32 * 22_669_344)
    blocks = counts.rfb_blocks(PUBLISHED)
    assert len(blocks) == 123 and blocks[0] == (64, 32, 1) and blocks[4] == (192, 64, 1)
    assert (blocks[120], blocks[121], blocks[122]) == ((64, 64, 1), (64, 64, 4), (64, 64, 16))
    # the middle RFB at batch 192: 192 x 1024 px, 2 x 23,392 MACs each at 989 TFLOP/s against
    # 128 bf16 channels in and out at 3.35 TB/s: bound by bytes
    px = 192 * 32 * 32
    assert counts.rfb_fwd_bound_s(PUBLISHED, 120, 192, 32, 32) == pytest.approx(
        max(2 * 23_392 * px / 989e12, px * 128 * 2 / 3.35e12))


def test_reference_names_are_the_ports_at_the_published_widths():
    from climsr_tpu_torch.models.rfb_esrgan import RFBESRGANGenerator

    with torch.device("meta"):
        port = RFBESRGANGenerator(**{k: v for k, v in PUBLISHED.items() if k not in ("name", "nf", "gc")})
    shapes = ref.param_shapes(PUBLISHED)
    assert [(k, tuple(v.shape)) for k, v in port.state_dict().items()] == [(k, s) for k, s, _ in shapes]
    assert len(shapes) == 1966 and sum(math.prod(s) for _, s, _ in shapes) == 21_244_320
    assert [k for k, _, kaiming in shapes if not kaiming] == ["conv1.weight", "upsampling.2.weight", "conv3.0.weight",
                                                              "conv4.0.weight"]


def _pass(device=True):
    """A forward span (0-50 ms) holding two RFB spans (keys 0 and 120), and
    device events launched inside them, inside the forward alone, and outside it."""
    from climsr_tpu_torch.utils.profiling import Span

    ms = 1_000_000
    spans = [Span(train_rfb.FORWARD, 1, 0, 50 * ms, None, None, 0),
             Span(train_rfb.BLOCK, 1, 10 * ms, 20 * ms, 0, 0, 1), Span(train_rfb.BLOCK, 1, 30 * ms, 40 * ms, 0, 120, 2)]
    events = [DeviceEvent("conv", "kernel", 12 * ms, 20 * ms, 5 * ms),
              DeviceEvent("b1", "kernel", 20 * ms, 23 * ms, 11 * ms),
              DeviceEvent("cat", "kernel", 40 * ms, 41 * ms, 35 * ms),
              DeviceEvent("opt", "kernel", 60 * ms, 70 * ms, 55 * ms)]
    return SpanPass((0, 100 * ms), events, spans, {train_rfb.CALLS: 2}, 1, device=device)


def test_span_readings_and_the_metrics_that_read_them(rfb_bench):
    got = train_rfb.rfb_readings(_pass())
    assert got == {"block_spans": 2, "block_calls": 2, "forward_spans": 1, "keys": {0: 1, 120: 1},
                   "block_device_s": pytest.approx(0.004), "forward_device_s": pytest.approx(0.012)}
    assert train_rfb.rfb_readings(_pass(device=False)) == {"block_spans": 2, "block_calls": 2, "forward_spans": 1,
                                                           "keys": {0: 1, 120: 1}}
    assert train_rfb.rfb_readings(None) == {}
    cell = harness.load_cell("rfb-esrgan.pretrain-b192")
    # the notes as the run line's JSON carries them: keys as strings
    notes = {"rfb": dict(got, keys={"0": 3, "120": 2})}
    out = harness.Outcome("train", {}, 0, 0, 0, {}, notes=notes)
    assert harness.reader("rfb_fwd_pct").read(out, cell) == pytest.approx(100 * 4 / 12)
    want = 100 * (3 * counts.rfb_fwd_bound_s(PUBLISHED, 0, 192, 32, 32)
                  + 2 * counts.rfb_fwd_bound_s(PUBLISHED, 120, 192, 32, 32)) / 0.004
    assert harness.reader("rfb_roofline_pct").read(out, cell) == pytest.approx(want)
    for notes in ({}, {"rfb": {}}, {"rfb": {"block_spans": 0, "block_calls": 0, "forward_spans": 10, "keys": {},
                                            "block_device_s": 0.0, "forward_device_s": 1.0}}):
        bare = harness.Outcome("train", {}, 0, 0, 0, {}, notes=notes)  # a program without the spans
        assert harness.reader("rfb_fwd_pct").read(bare, cell) is None
        assert harness.reader("rfb_roofline_pct").read(bare, cell) is None


def test_sound_run_is_correct_and_traced_records_the_blocks(rfb_bench):
    cell, out, line = run_cell(rfb_bench, TINY, seed=SEED, trace=True)
    assert line["correct"] is True and set(line["checks"]) == set(cell.limits)
    steps = cell.traffic["traced_steps"]
    assert out.notes["rfb"] == {"block_spans": 18 * steps, "block_calls": 18 * steps, "forward_spans": steps,
                                "keys": {k: steps for k in range(18)}}
    assert set(line["metrics"]) == {"train_mfu"}  # the span metrics read device time, which the CPU has not


@pytest.mark.parametrize("fault", ["undilated", "dense_concat_short"])
def test_fault_is_not_correct(rfb_bench, fault):
    with getattr(faults_rfb, fault)():
        line = run_cell(rfb_bench, TINY, seed=SEED)[2]
    assert line["correct"] is False


def test_control_is_not_correct(rfb_bench):
    cell, out, _ = run_cell(rfb_bench, TINY, seed=SEED, control=True)
    assert not harness.passed(harness.judge(cell, out.checks))


@pytest.mark.parametrize("override", ["generator.num_rrfdb_blocks=2", "training.generator_type=esrgan",
                                      "training.batch_size=2", "trainer.precision=fp32"])
def test_a_departing_composition_raises(rfb_bench, override):
    mix = json.loads((rfb_bench / "traffic" / "tiny-rfb-pretrain.json").read_text())
    mix["overrides"].append(override)
    (rfb_bench / "traffic" / "tiny-rfb-pretrain.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="departs from the cell"):
        run_cell(rfb_bench, TINY, seed=SEED)
