"""The span pass (``perfbench/spans.py``): its readers on hand-made timelines,
a tiny CPU cell run with it, and the pass on the card."""
import time

import pytest
import torch
from perfbench_support import cuda_or_skip, run_cell, tiny_bench  # noqa: F401 (a fixture)

from climsr_tpu_torch.utils.profiling import Span
from perfbench import harness, spans
from perfbench.spans import DeviceEvent, SpanPass

MS = 1_000_000  # ns
MAIN, WRITER = 100, 200


def _span(index, name, start_ms, end_ms, parent=None, thread=MAIN, key=None):
    return Span(name, thread, start_ms * MS, end_ms * MS, parent, key, index)


def _pass(events, span_list, counts=None, device=True):
    return SpanPass((0, 100 * MS), events, span_list, counts or {}, MAIN, device=device)


def _event(start_ms, end_ms, kind="kernel", launch_ms=None, name="k"):
    return DeviceEvent(name, kind, start_ms * MS, end_ms * MS, None if launch_ms is None else launch_ms * MS)


def test_idle_inside_a_span_is_the_idle_share_while_the_main_thread_is_in_it():
    # busy 0-10 and 30-60 (an "other" event 10-30 is not busy); load_month 5-40 and 90-95 on the main thread,
    # one on a writer thread 40-90 that does not count
    events = [_event(0, 10), _event(10, 30, kind="other"), _event(30, 50, kind="copy"), _event(45, 60, kind="set")]
    loads = [_span(0, spans.LOAD, 5, 40), _span(1, spans.LOAD, 90, 95), _span(2, spans.LOAD, 40, 90, thread=WRITER)]
    sp = _pass(events, loads)
    assert sp.busy() == [(0, 10 * MS), (30 * MS, 60 * MS)]
    assert spans.idle_inside_pct(sp, spans.LOAD) == pytest.approx(100.0 * (20 + 5) / 100)
    assert spans.idle_inside_pct(sp, spans.WRITER_WAIT) is None
    assert spans.idle_inside_pct(_pass(events, loads, device=False), spans.LOAD) is None
    assert spans.idle_inside_pct(None, spans.LOAD) is None


def test_untraced_idle_is_device_time_a_unit_over_untraced_seconds_a_unit():
    sp = _pass([_event(0, 40), _event(20, 60)], [], {spans.STEPS: 4})  # 60 ms busy over 4 steps: 15 ms a step
    assert spans.idle_untraced_pct(sp, spans.STEPS, window_s=2.0, units=100) == pytest.approx(25.0)  # 20 ms a step
    assert spans.idle_untraced_pct(sp, spans.STEPS, window_s=1.0, units=100) == pytest.approx(-50.0)  # not clamped
    assert spans.idle_untraced_pct(sp, spans.MONTHS, window_s=2.0, units=100) is None
    assert spans.idle_untraced_pct(sp, spans.STEPS, window_s=0.0, units=100) is None
    assert spans.idle_untraced_pct(_pass([], [], {spans.STEPS: 4}, device=False), spans.STEPS, 2.0, 100) is None


def test_dispatch_is_the_mean_host_ms_inside_the_main_threads_steps():
    steps = [_span(0, spans.STEP, 0, 10, key=0), _span(1, "climsr.step.forward", 1, 4, parent=0),
             _span(2, spans.STEP, 20, 40, key=1), _span(3, spans.STEP, 50, 90, thread=WRITER)]
    assert spans.dispatch_ms(_pass([], steps, device=False)) == pytest.approx(15.0)
    assert spans.dispatch_ms(_pass([], steps[1:2])) is None and spans.dispatch_ms(None) is None


def test_device_time_goes_to_the_main_threads_span_open_at_its_launch_and_its_parents():
    span_list = [_span(0, spans.STEP, 0, 50), _span(1, "climsr.step.forward", 5, 20, parent=0),
                 _span(2, "climsr.sweep.readback", 10, 30, parent=0, thread=WRITER)]
    events = [_event(20, 30, launch_ms=6), _event(30, 32, launch_ms=25),  # forward's, then the step's own
              _event(40, 45, kind="copy", launch_ms=12),  # at 12 the main thread is in forward
              _event(50, 60, launch_ms=70), _event(60, 61, kind="other", launch_ms=7)]  # no span; not busy
    device = spans.attribute(_pass(events, span_list))
    assert device == {1: 15 * MS, 0: 17 * MS}
    sp = _pass(events, span_list, {spans.STEPS: 2})
    rows = {line.split()[0]: line.split()[1:] for line in spans.table(sp).splitlines()[1:-1]}
    assert rows[spans.STEP] == ["1", "25.000", "17.500", "8.500"]  # per step, of 2
    assert spans.launches_outside(sp) == {"k": 1}


def test_overlaps_of_the_month_list_by_event():
    sp = _pass([_event(0, 10, name="a"), _event(5, 25, kind="other", name="b"), _event(50, 60, name="c")],
               [_span(0, spans.LOAD, 8, 20), _span(1, spans.LOAD, 20, 30)])
    assert spans.load_overlaps(sp) == [("b", "other", 1, 17.0), ("a", "kernel", 1, 2.0)]


class _Kineto:
    """A profiler event as ``kineto_results.events()`` gives it (older torch
    names no activity type)."""

    def __init__(self, name, device, kind, start, end, corr=0):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, kind, int(start * MS), int(end * MS), corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return 0


class _NamedKineto(_Kineto):
    def activity_type(self):
        return self._v[2]


@pytest.mark.parametrize("event", [_Kineto, _NamedKineto], ids=["by-name", "by-activity"])
def test_a_trace_becomes_the_stamps_window_with_each_events_kind_and_launch(event):
    class Rec:
        spans, counts, thread = [_span(0, spans.STEP, 1, 9)], {spans.STEPS: 1}, MAIN

    trace = [event("cudaLaunchKernel", False, "cuda_runtime", 2, 2.01, corr=7),
             event("first", True, "kernel", 1, 1.1), event("k", True, "kernel", 3, 5, corr=7),
             event("Memcpy DtoH (Device -> Pinned)", True, "gpu_memcpy", 5, 6, corr=8),
             event("Memset (Device)", True, "gpu_memset", 4, 8), event("last", True, "kernel", 9, 9.1)]
    sp = spans._from_trace(trace, Rec, (0, 10 * MS))
    assert sp.window == (0, 10 * MS) and sp.info["clock_ok"] and sp.info["first_event"] == ["first", 1000.0]
    assert [(e.name[:6], e.kind, e.launch_ns) for e in sp.events] == [
        ("first", "kernel", None), ("k", "kernel", 2 * MS), ("Memset", "set", None), ("Memcpy", "copy", None),
        ("last", "kernel", None)]
    assert sp.busy() == [(1 * MS, int(1.1 * MS)), (3 * MS, 8 * MS), (9 * MS, int(9.1 * MS))]
    assert sp.info["linked"] == 1 and not spans._from_trace(trace, Rec, (2 * MS, 10 * MS)).info["clock_ok"]


@pytest.mark.parametrize("name, per_layer, counter", [
    ("tiny.pretrain", {"train_mfu"}, spans.STEPS),
    ("tiny.gan", {"train_mfu"}, spans.STEPS),
    ("tiny.sweep", {"sweep_mfu"}, spans.MONTHS),
])
def test_tiny_cells_traced_lines_and_span_pass_on_the_cpu(tiny_bench, name, per_layer, counter):
    """The traced line prints exactly the cell's own metrics; the span pass
    reads the program's spans and counters (no device readings on the CPU),
    and the full profile's ranges lie inside their spans."""
    _, _, line = run_cell(tiny_bench, name, trace=True)
    assert set(line["metrics"]) == per_layer
    cell = harness.load_cell(name, tiny_bench / "BENCHMARK.json", tiny_bench)
    out, found = spans.run_cell(cell, 11, 0.5, torch.device("cpu"))
    sp = found["span_pass"]
    assert not sp.device and sp.counts[counter] > 0
    got = spans.readings(out, sp)
    if out.kind == "train":
        assert sp.counts[counter] == cell.traffic["traced_steps"] and set(got) == {"train_dispatch_ms"}
    else:
        assert sp.counts[counter] == cell.traffic["months"] and got == {}
    full, prof = found["full"]
    checked = spans.brackets(full, prof.profiler.kineto_results.events())
    assert checked["outside"] == 0 and checked["unpaired"] == {}
    assert checked["paired"] + sum(checked["not_in_profile"].values()) == len(full) and checked["paired"] > 0
    assert harness.result_line(cell, out, True, "cpu", 1, platform="cpu")["metrics"].keys() == per_layer
    assert spans.table(sp).count("climsr.") > 3


@pytest.mark.cuda
def test_span_pass_on_the_card():
    """Kernels launched inside the program's spans, the host asleep between
    them: every event lies inside the host's stamps, carries its launch and
    falls inside a step, and the window's idle share sits where the host slept."""
    device = cuda_or_skip()
    from climsr_tpu_torch.utils.profiling import span

    x = torch.randn(2048, 2048, device=device)

    def run():
        for k in range(4):
            with span(spans.STEP, key=k):
                for _ in range(8):
                    x.mul_(1.0001)
            torch.cuda.synchronize(device)
            with span(spans.LOAD, key=k):
                time.sleep(0.02)

    sp = spans.span_pass(device, run)
    assert sp.device and sp.info["clock_ok"], sp.info
    kernels = [e for e in sp.events if e.kind == "kernel"]
    assert len(kernels) == 32 and all(e.launch_ns is not None for e in kernels), sp.info
    assert spans.launches_outside(sp) == {}
    assert 70.0 < spans.idle_inside_pct(sp, spans.LOAD) < 100.0
    assert 0.0 < spans.dispatch_ms(sp) < 20.0
