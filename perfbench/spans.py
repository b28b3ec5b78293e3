#!/usr/bin/env python3
"""The program's own spans and counters (``climsr_tpu_torch.utils.profiling``)
on the device trace's clock: the span pass, its readers and its notes.

:func:`span_pass` runs a traced run's work once more, after the device-only
pass and the full profile, with device activity alone recorded (as
``trace.device_pass``) and the program's recording on. It returns the device
events with their kind (kernel, copy, set, other) and the moment of the
runtime call that launched each, the program's spans and its counters, all
in ``time.time_ns()``: the profiler's event times are on that clock (a span's
interval holds its own ``record_function`` range in a profile;
:func:`brackets` checks it). So the window runs from a host stamp taken on
the idle device before the work to one taken after its closing synchronize,
and every device event of the pass must fall inside it (``clock_ok``). It
rests on no marker operation's being recorded: the profiler can drop the
first operation launched after it starts, and a window opened at the first
recorded operation then begins at the work's first kernel. "Busy" is the
union of the kernels', copies' and sets' intervals, so overlapping streams
count once.

The readers (``None`` where there is nothing to read; the device-based ones
on the CPU):

- :func:`idle_inside_pct`: the share of the window in which the device is
  idle while the main thread is inside a span of a name
  (``climsr.sweep.load_month``, ``climsr.sweep.writer_wait``);
- :func:`idle_untraced_pct`: 100 x (1 - (busy s / a counter) / (the
  untraced window's s / the units it ran)): device time per unit of work,
  which does not depend on how slow the traced host runs, over the untraced
  seconds per unit; not clamped, a negative reading is a finding;
- :func:`dispatch_ms`: the mean host ms the main thread spends inside
  ``climsr.train.step``.

:func:`readings` gives a traced run's five readings by metric name. The
notes: :func:`table`, host ms per step or per pass by span (total, self) and
the device ms launched inside each; :func:`load_overlaps`, the device events
that overlap the month list; the clock checks :func:`brackets` (a full
profile's ranges inside their spans) and :func:`launches_outside` (kernels
launched outside every step).

Run as a script, it runs one cell with ``--trace 1`` as ``run.py`` does, with
the program's recording on in the full profile and the span pass after it,
and prints the readings, the notes and the clock checks; with
``--untraced-recording`` it runs the cell untraced with the recording on,
for the cost of recording against a run of ``run.py`` on the same seed:

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> [--untraced-recording]
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.trace import _union  # noqa: E402

BUSY = ("kernel", "copy", "set")
_KINDS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "set"}
_LAUNCHES = ("cuda_runtime", "cuda_driver")
STEP, STEPS, MONTHS = "climsr.train.step", "climsr.train.steps", "climsr.sweep.months"
LOAD, WRITER_WAIT = "climsr.sweep.load_month", "climsr.sweep.writer_wait"


@dataclass
class DeviceEvent:
    name: str
    kind: str  # kernel, copy, set or other
    start_ns: int
    end_ns: int
    launch_ns: Optional[int] = None  # the runtime call that launched it, where the trace links one


@dataclass
class SpanPass:
    """One span pass: ``window`` (ns), the device ``events`` inside it, the
    program's ``spans`` (``profiling.Span``) and ``counts``, and ``thread``,
    the thread that ran the work. ``device`` is False on the CPU, where only
    the spans and counters are read."""

    window: Tuple[int, int]
    events: List[DeviceEvent]
    spans: list
    counts: Dict[str, int]
    thread: int
    device: bool = True
    info: Dict[str, object] = field(default_factory=dict)  # what the trace held, for the notes

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        return union([(e.start_ns, e.end_ns) for e in self.events if e.kind in BUSY])

    def main_spans(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.thread == self.thread]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The non-empty intervals merged, in order."""
    return _union([(a, b) for a, b in intervals if b > a])


def overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """The length both unions of disjoint sorted intervals cover."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _recording():
    """The program's recorder, or None where the program has none."""
    try:
        from climsr_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    return recording


def span_pass(device, run: Callable[[], None]) -> Optional[SpanPass]:
    """``run()`` with the program's recording on and, on a card, device
    activity alone profiled, between host stamps on the idle device; None
    (and nothing run) where the program records no spans."""
    recording = _recording()
    if recording is None:
        return None
    if device.type != "cuda":
        with recording() as rec:
            t0 = time.time_ns()
            run()
            t1 = time.time_ns()
        return SpanPass((t0, t1), [], list(rec.spans), dict(rec.counts), rec.thread, device=False)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            t0 = time.time_ns()
            run()
            torch.cuda.synchronize(device)
            t1 = time.time_ns()
    return _from_trace(prof.profiler.kineto_results.events(), rec, (t0, t1))


def _kind(e) -> str:
    """kernel, copy, set or other: from the event's activity type where the
    profiler names it (newer torch), else from its name."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        return _KINDS.get(activity(), "other")
    if getattr(e, "is_user_annotation", lambda: False)():
        return "other"
    name = e.name()
    return "copy" if name.startswith("Memcpy") else "set" if name.startswith("Memset") else "kernel"


def _is_launch(e) -> bool:
    """A host-side CUDA runtime or driver call (with device activity alone,
    the only host events the profile holds but the program's ranges)."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        return activity() in _LAUNCHES
    return e.name().startswith("cu")


def _from_trace(kineto_events, rec, stamps: Tuple[int, int]) -> SpanPass:
    from torch.autograd import DeviceType

    launches: Dict[int, int] = {}
    device = []
    for e in kineto_events:
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.correlation_id() and _is_launch(e):
            launches[e.correlation_id()] = e.start_ns()
    if not device:
        raise RuntimeError("the span pass's profile holds no device event")
    device.sort(key=lambda e: e.start_ns())
    events = [DeviceEvent(e.name(), _kind(e), e.start_ns(), e.start_ns() + e.duration_ns(),
                          launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id()))
              for e in device]
    kinds: Dict[str, List[float]] = {}
    for e in events:
        row = kinds.setdefault(e.kind, [0, 0.0])
        row[0] += 1
        row[1] += (e.end_ns - e.start_ns) / 1e6
    t0, t1 = stamps
    info = {"events_by_kind": kinds, "linked": sum(e.launch_ns is not None for e in events),
            "other_events": sorted({e.name[:60] for e in events if e.kind == "other"})[:10],
            "first_event": [events[0].name[:120], (events[0].start_ns - t0) / 1e3],
            "last_event": [events[-1].name[:120], (t1 - max(e.end_ns for e in events)) / 1e3],
            "clock_ok": t0 <= events[0].start_ns and max(e.end_ns for e in events) <= t1}
    return SpanPass(stamps, events, list(rec.spans), dict(rec.counts), rec.thread, info=info)


# ---- readers


def idle_inside_pct(sp: Optional[SpanPass], name: str) -> Optional[float]:
    if sp is None or not sp.device:
        return None
    inside = union([(max(s.start_ns, sp.window[0]), min(s.end_ns, sp.window[1])) for s in sp.main_spans(name)])
    if not inside or sp.window_s <= 0:
        return None
    edges = [sp.window[0]] + [t for ab in sp.busy() for t in ab] + [sp.window[1]]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return 100.0 * overlap(inside, idle) / (sp.window[1] - sp.window[0])


def idle_untraced_pct(sp: Optional[SpanPass], counter: str, window_s: float, units: int) -> Optional[float]:
    if sp is None or not sp.device or not sp.counts.get(counter) or window_s <= 0 or units <= 0:
        return None
    busy_s = sum(b - a for a, b in sp.busy()) / 1e9
    return 100.0 * (1.0 - (busy_s / sp.counts[counter]) / (window_s / units))


def dispatch_ms(sp: Optional[SpanPass]) -> Optional[float]:
    steps = [] if sp is None else sp.main_spans(STEP)
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6


def readings(out, sp: Optional[SpanPass]) -> Dict[str, float]:
    """A traced run's readings by metric name (those with something to read):
    ``out`` is the run's ``harness.Outcome`` (its untraced window and the
    steps or months it ran)."""
    if out.kind == "train":
        got = {"train_idle_untraced_pct": idle_untraced_pct(sp, STEPS, out.window_s, out.attempted),
               "train_dispatch_ms": dispatch_ms(sp)}
    else:
        got = {"sweep_idle_load_pct": idle_inside_pct(sp, LOAD),
               "sweep_idle_writer_pct": idle_inside_pct(sp, WRITER_WAIT),
               "sweep_idle_untraced_pct": idle_untraced_pct(sp, MONTHS, out.window_s, out.attempted)}
    return {k: v for k, v in got.items() if v is not None}


# ---- notes


def _innermost(spans: list) -> Callable[[int], Optional[object]]:
    """t -> the innermost of ``spans`` (one thread's, nested) open at t."""
    order = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in order]
    by_index = {s.index: s for s in spans}

    def at(t: int):
        i = bisect.bisect_right(starts, t) - 1
        s = order[i] if i >= 0 else None
        while s is not None and not (s.start_ns <= t < s.end_ns):
            s = by_index.get(s.parent)
        return s

    return at


def attribute(sp: SpanPass) -> Dict[int, int]:
    """Span index -> the device ns of the busy events launched inside it or
    its children: each event goes to the main thread's innermost span open at
    its launch (the trace names no launching thread: the autograd engine's
    launches of a backward fall in ``climsr.step.backward``, a writer's
    readback in what the main thread was doing then)."""
    main = [s for s in sp.spans if s.thread == sp.thread]
    find = _innermost(main)
    by_index = {s.index: s for s in main}
    device: Dict[int, int] = {}
    for e in sp.events:
        if e.kind not in BUSY or e.launch_ns is None:
            continue
        s = find(e.launch_ns)
        while s is not None:
            device[s.index] = device.get(s.index, 0) + (e.end_ns - e.start_ns)
            s = by_index.get(s.parent)
    return device


def load_overlaps(sp: SpanPass, top: int = 12) -> List[Tuple[str, str, int, float]]:
    """The device events that overlap the month list's spans: (name, kind,
    events, ms of overlap), longest first."""
    loads = union([(s.start_ns, s.end_ns) for s in sp.main_spans(LOAD)])
    got: Dict[Tuple[str, str], List[float]] = {}
    for e in sp.events:
        ns = overlap(loads, [(e.start_ns, e.end_ns)])
        if ns > 0:
            row = got.setdefault((e.name[:60], e.kind), [0, 0.0])
            row[0] += 1
            row[1] += ns / 1e6
    return sorted(((n, k, c, ms) for (n, k), (c, ms) in got.items()), key=lambda r: -r[3])[:top]


def table(sp: SpanPass) -> str:
    """Host ms per step (or per pass, one sweep) by span name: total and self
    (less the children on its thread), and the device ms launched inside."""
    steps = sp.counts.get(STEPS)
    per, unit = (steps, "step") if steps else (1, "pass")
    device = attribute(sp) if sp.device else {}
    rows: Dict[str, List[float]] = {}
    child_ns: Dict[int, int] = {}
    by_index = {s.index: s for s in sp.spans}
    for s in sp.spans:
        p = by_index.get(s.parent)
        if p is not None and p.thread == s.thread:
            child_ns[p.index] = child_ns.get(p.index, 0) + (s.end_ns - s.start_ns)
    for s in sp.spans:
        row = rows.setdefault(s.name, [0, 0.0, 0.0, 0.0])
        ns = s.end_ns - s.start_ns
        row[0] += 1
        row[1] += ns / 1e6 / per
        row[2] += (ns - child_ns.get(s.index, 0)) / 1e6 / per
        row[3] += device.get(s.index, 0) / 1e6 / per
    width = max((len(n) for n in rows), default=10)
    lines = [f"  {'span':<{width}}  {'count':>6}  {'host ms/' + unit:>12}  {'self ms':>9}  {'device ms':>9}"]
    for name, (n, host, own, dev) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:<{width}}  {n:6d}  {host:12.3f}  {own:9.3f}  {dev if sp.device else float('nan'):9.3f}")
    if sp.device:
        busy = sum(b - a for a, b in sp.busy()) / 1e6
        lines.append(f"  window {sp.window_s * 1e3:.3f} ms, busy {busy:.3f} ms, counters {sp.counts}")
    return "\n".join(lines)


def brackets(spans: list, kineto_events) -> Dict[str, object]:
    """Each span against the ``record_function`` range of its name that a
    profile recorded for it (the n-th of a name with the n-th): how many were
    paired, how many ranges fell outside their span, the least margins (us)
    at the start and at the end, the names whose counts differ, and the
    spans of names the profile holds no range of (a thread it did not
    record: the sweep's writers)."""
    from torch.autograd import DeviceType

    ranges: Dict[str, list] = {}
    for e in kineto_events:  # the host's ranges (a device annotation may repeat a name)
        if e.device_type() == DeviceType.CPU and e.name().startswith("climsr."):
            ranges.setdefault(e.name(), []).append(e)
    paired, outside, lead, tail, unpaired, absent = 0, 0, float("inf"), float("inf"), {}, {}
    for name in sorted({s.name for s in spans}):
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted(ranges.get(name, []), key=lambda e: e.start_ns())
        if not theirs:
            absent[name] = len(mine)
            continue
        if len(mine) != len(theirs):
            unpaired[name] = [len(mine), len(theirs)]
            continue
        for s, r in zip(mine, theirs):
            paired += 1
            a, b = (r.start_ns() - s.start_ns) / 1e3, (s.end_ns - r.start_ns() - r.duration_ns()) / 1e3
            outside += a < 0 or b < 0
            lead, tail = min(lead, a), min(tail, b)
    return {"paired": paired, "outside": outside, "least_lead_us": lead, "least_tail_us": tail,
            "unpaired": unpaired, "not_in_profile": absent}


def launches_outside(sp: SpanPass, name: str = STEP) -> Dict[str, int]:
    """The kernels launched in the window at no moment inside a span of
    ``name`` (on any thread), by kernel name."""
    inside = union([(s.start_ns, s.end_ns) for s in sp.spans if s.name == name])
    starts = [a for a, _ in inside]
    got: Dict[str, int] = {}
    for e in sp.events:
        if e.kind != "kernel" or e.launch_ns is None:
            continue
        i = bisect.bisect_right(starts, e.launch_ns) - 1
        if i < 0 or e.launch_ns >= inside[i][1]:
            got[e.name[:60]] = got.get(e.name[:60], 0) + 1
    return got


# ---- the script


@contextlib.contextmanager
def _entry_with_span_pass(entry, device, found: dict):
    """While the block runs, ``entry``'s traced run records the program's
    spans in its full profile and runs :func:`span_pass` after it."""
    recording = _recording()
    names = ("device_pass", "profiled", "read_trace")
    saved = {n: getattr(entry, n) for n in names}

    def device_pass(dev, run, *args, **kwargs):
        found["run"] = run
        return saved["device_pass"](dev, run, *args, **kwargs)

    @contextlib.contextmanager
    def profiled():
        with recording() as rec, saved["profiled"]() as holder:
            yield holder
        found["full"] = (list(rec.spans), holder[0])

    def read_trace(prof, timeline, *args, **kwargs):
        summary = saved["read_trace"](prof, timeline, *args, **kwargs)
        found["span_pass"] = span_pass(device, found["run"])
        return summary

    for n, f in zip(names, (device_pass, profiled, read_trace)):
        setattr(entry, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(entry, n, f)


def run_cell(cell, seed: int, seconds: float, device, untraced_recording: bool = False):
    """The cell's run as ``run.py --trace 1`` makes it, with the span pass
    (or untraced with the recording on): (outcome, what was found)."""
    from perfbench import harness

    found: dict = {}
    if untraced_recording:
        with _recording()() as rec:
            out = harness.run_entry(cell, seed, seconds, False, device, START)
        found["counts"] = dict(rec.counts)
        return out, found
    entry = importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")
    with _entry_with_span_pass(entry, device, found):
        out = harness.run_entry(cell, seed, seconds, True, device, START)
    return out, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--untraced-recording", action="store_true")
    args = ap.parse_args(argv)

    from perfbench import harness

    if _recording() is None:
        print("the program records no spans (climsr_tpu_torch.utils.profiling has no recording)", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out, found = run_cell(cell, args.seed, args.seconds, device, args.untraced_recording)
    line: Dict[str, object] = {"workload": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(0)}
    if args.untraced_recording:
        line.update(recording=True, end_to_end=out.end_to_end, counts=found["counts"])
    else:
        sp = found.get("span_pass")
        spans, prof = found["full"]
        result = harness.result_line(cell, out, True, torch.cuda.get_device_name(0), cell.chips)
        line.update(readings=readings(out, sp), per_layer=result["metrics"], device_pass=result["device"],
            full_pass_brackets=brackets(spans, prof.profiler.kineto_results.events()),
            info=sp.info if sp is not None else None)
        if sp is not None:
            print(table(sp), file=sys.stderr)
            if out.kind == "sweep":
                line["load_month_overlaps"] = load_overlaps(sp)
            else:
                line["kernels_launched_outside_steps"] = launches_outside(sp)
    print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
