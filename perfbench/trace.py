"""The traced run's reading of a ``torch.profiler`` trace, and the harness's
own spans around the calls into the port's layers.

Spans are ``record_function`` ranges that the harness opens around the port's
entry points while a traced window runs (:class:`Spans`); nothing is wrapped
in an untraced run. A span named ``perfbench.rdb|<kind>|n,c,h,w|x0|gc|dtype``
marks one call of the RDB kernels' entry point (kind A: ``fused_rdb`` without
a gradient, B1: ``fused_rdb_fwd_save``, B2: ``fused_rdb_bwd``) with the
shape its bound is counted at; the device time of a call is that of every
operation that ran inside the span, whatever its name.

A traced run runs its traced work twice. First under :func:`device_pass`,
which records device activity alone: no host op is recorded, so the host
runs near its untraced pace and the idle share is the program's more than
the profiler's (with host ops recorded, a host-bound step's host work
doubles and its idle share with it; the recording of the CUDA runtime's
calls still slows it some). Its timeline gives the window's length (between two marker
operations launched on an idle device before and after the work), the
seconds in which any device operation ran (the union of the kernels',
copies' and sets' intervals, so overlapping streams count once) and the
device operations that took most time. Then under :func:`profiled`, with
host and device activity and the harness's spans open, from which
:func:`read_trace` takes the idle gaps summed by what the host was doing at
their middle, and each RDB span's device time (the operations that ran
inside the span's annotation on the device timeline).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
RDB_SPAN = "perfbench.rdb"


@dataclass
class DeviceTimeline:
    """What a device-only profile gives: the window, the busy seconds in it
    and the device operations that took most time."""

    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    ops: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    rdb_calls: List[Tuple[str, float]] = field(default_factory=list)  # (span name, device seconds)
    counts: Dict[str, int] = field(default_factory=dict)  # what the trace held, for the run's notes


def _rdb_name(kind: str, x: torch.Tensor, gc: int, x0: bool) -> str:
    n, c, h, w = x.shape
    dtype = str(x.dtype).replace("torch.", "")
    return f"{RDB_SPAN}|{kind}|{n},{c},{h},{w}|{int(x0)}|{gc}|{dtype}"


def parse_rdb_name(name: str) -> Tuple[str, Tuple[int, ...], bool, int, str]:
    _, kind, shape, x0, gc, dtype = name.split("|")
    return kind, tuple(int(v) for v in shape.split(",")), x0 == "1", int(gc), dtype


class Spans:
    """Wraps the port's entry points in ``record_function`` ranges while active."""

    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, name: Optional[str] = None,
             namer: Optional[Callable[..., Optional[str]]] = None) -> None:
        """``owner.attr`` runs inside a span named ``name``, or ``namer(*args,
        **kwargs)`` (no span where it gives None)."""
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def spanned(*args, **kwargs):
            label = namer(*args, **kwargs) if namer is not None else name
            if label is None:
                return inner(*args, **kwargs)
            with torch.profiler.record_function(label):
                return inner(*args, **kwargs)

        setattr(owner, attr, spanned)
        self._undo.append(lambda: setattr(owner, attr, inner))

    def rdb(self) -> None:
        """Kernels A, B1 and B2 at their call sites: ``models.esrgan.fused_rdb``
        (A where no gradient is needed), ``ops.rdb.fused_rdb_fwd_save`` and
        ``ops.rdb.fused_rdb_bwd`` (looked up by ``FusedRDB`` at each call)."""
        from climsr_tpu_torch.models import esrgan
        from climsr_tpu_torch.ops import rdb

        def a_name(x, weights, x0=None, packed=None):
            tensors = [x] + ([x0] if x0 is not None else []) + [t for wb in weights for t in wb]
            if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
                return None  # FusedRDB: B1 and B2 carry their own spans
            return _rdb_name("A", x, weights[0][0].shape[0], x0 is not None)

        def b1_name(x, weights, x0=None, packed=None):
            return _rdb_name("B1", x, weights[0][0].shape[0], x0 is not None)

        def b2_name(feat, g, weights, gy_scale, gx_scale):
            return _rdb_name("B2", g, weights[0][0].shape[0], gy_scale != 0.2)

        self.wrap(esrgan, "fused_rdb", namer=a_name)
        self.wrap(rdb, "fused_rdb_fwd_save", namer=b1_name)
        self.wrap(rdb, "fused_rdb_bwd", namer=b2_name)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


@contextlib.contextmanager
def profiled() -> Iterator[list]:
    """Profile the block (CPU and CUDA activity); the block's work must end
    inside a ``WINDOW`` span. Yields a list that holds the profiler after the block."""
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    out.append(prof)


def device_pass(device, run: Callable[[], None], top: int = 10) -> Optional[DeviceTimeline]:
    """``run()`` profiled with device activity alone, bracketed by a marker
    operation on the idle device before and after it; None without a CUDA
    device (nothing runs on a device timeline there)."""
    if device.type != "cuda":
        run()
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        run()
        torch.cuda.synchronize(device)
        marker.add_(1)
        torch.cuda.synchronize(device)
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    ops = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names),
                 key=lambda e: e.time_range.start)
    if len(ops) < 2:
        raise RuntimeError(f"the device-only profile holds {len(ops)} device operations, not the markers and the work")
    t0, t1 = ops[0].time_range.start, max(e.time_range.end for e in ops)
    busy, by_op = _busy(ops, t0, t1)
    rank = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return DeviceTimeline(window_s=(t1 - t0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                          device_ops=[(k, v / 1e6) for k, v in rank], ops=len(ops))


def _busy(ops, t0: float, t1: float) -> Tuple[List[Tuple[float, float]], Dict[str, float]]:
    """The intervals in [t0, t1] in which any of ``ops`` ran (merged), and each op name's microseconds."""
    inside = [(max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in ops]
    by_op: Dict[str, float] = {}
    for e, (a, b) in zip(ops, inside):
        if b > a:
            by_op[e.name] = by_op.get(e.name, 0.0) + (b - a)
    return _union([(a, b) for a, b in inside if b > a]), by_op


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def read_trace(prof, timeline: Optional[DeviceTimeline], top: int = 10) -> TraceSummary:
    """The summary of a traced run: the window, busy seconds and device
    operations of ``timeline`` (the device-only pass), the idle gaps by host
    op and the RDB calls of ``prof`` (the full pass). Without a device
    timeline (no CUDA device) the full pass's window and busy seconds stand in."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    windows = [e for e in cpu if e.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span on the host in the trace, found {len(windows)}")
    win = windows[0]
    cpu.remove(win)
    t0, t1 = win.time_range.start, win.time_range.end
    # on the device timeline a range of the host's (a record_function) shows
    # as an annotation of the same name over what was launched inside it; the
    # device's operations are the rest: kernels, copies, sets
    host_names = {e.name for e in cpu} | {WINDOW}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    marks = [e for e in device if e.name in host_names]
    ops = sorted((e for e in device if e.name not in host_names), key=lambda e: e.time_range.start)

    busy, by_op = _busy(ops, t0, t1)
    busy_us = sum(b - a for a, b in busy)

    # the host's innermost traced op at each idle gap's middle: the window's
    # own thread first, else the most recently started op on another thread
    threads: Dict[int, List] = {}
    for e in cpu:
        threads.setdefault(e.thread, []).append(e)
    starts = {}
    for th, evs in threads.items():
        evs.sort(key=lambda e: e.time_range.start)
        starts[th] = [e.time_range.start for e in evs]

    def innermost(th: int, t: float):
        # ops nest within a thread, so whatever covers t is the last op started
        # before t or one of its parents
        i = bisect.bisect_right(starts[th], t) - 1
        e = threads[th][i] if i >= 0 else None
        while e is not None and not (e.time_range.start <= t < e.time_range.end):
            e = e.cpu_parent
        return None if e is None or e is win else e

    gaps: Dict[str, float] = {}
    edges = [t0] + [v for ab in busy for v in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        hit = innermost(win.thread, mid) if win.thread in threads else None
        if hit is None:
            others = [x for th in threads if th != win.thread for x in [innermost(th, mid)] if x is not None]
            hit = max(others, key=lambda x: x.time_range.start) if others else None
        name = hit.name if hit is not None else "host (no traced op)"
        gaps[name] = gaps.get(name, 0.0) + (b - a)

    # each RDB call's device time: the operations that ran inside its annotation
    # on the device timeline (one stream: the call's own)
    op_starts = [e.time_range.start for e in ops]
    rdb_marks = [e for e in marks if e.name.startswith(RDB_SPAN + "|")]
    rdb_calls = []
    for m in rdb_marks:
        i, j = bisect.bisect_left(op_starts, m.time_range.start), bisect.bisect_left(op_starts, m.time_range.end)
        rdb_calls.append((m.name, sum(e.time_range.end - e.time_range.start for e in ops[i:j]) / 1e6))
    rank = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    counts = {"device_ops": len(ops), "device_marks": len(marks), "rdb_marks": len(rdb_marks),
              "rdb_ranges": sum(e.name.startswith(RDB_SPAN + "|") for e in cpu)}
    window_s, busy_s, device_ops = (t1 - t0) / 1e6, busy_us / 1e6, [(k, v / 1e6) for k, v in rank]
    if timeline is not None:
        counts.update(full_window_s=window_s, full_busy_s=busy_s, device_only_ops=timeline.ops)
        window_s, busy_s, device_ops = timeline.window_s, timeline.busy_s, timeline.device_ops
    return TraceSummary(window_s=window_s, busy_s=busy_s, device_ops=device_ops,
                        idle_gaps=[(k, v / 1e6) for k, v in idle], rdb_calls=rdb_calls, counts=counts)
