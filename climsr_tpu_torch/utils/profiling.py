# -*- coding: utf-8 -*-
"""Per-op device-time reports from ``torch.profiler``: the port of
``climsr_tpu.utils.profiling``.

The reference's ``profiler=advanced``/``pytorch`` (PL AdvancedProfiler /
PyTorchProfiler) produce per-function / per-op time tables. The JAX package
derives one from the xplane trace of ``jax.profiler``; the port from a
``torch.profiler`` trace of the same window (epoch 0): CUPTI records every
kernel on the card, the port's own kernels launched through ``ctypes``
(``rdb_fwd_bf16_kernel``, ``rdb_bwd_dx_bf16_kernel``, ``rdb_wgrad_*``,
``conv9_dx_c0``, ...) among them under their own names, and
:func:`aggregate_device_ops` sums their self device time by name. Without
a card (the CPU tests) the ops' self CPU time stands in, as the JAX package
reads the host plane on its CPU backend. :func:`format_op_table` is the JAX
table, copied as it is.

Spans and counters: :func:`span` marks a stage of the program's own work
(``climsr.sweep.*``, ``climsr.train.*``, ``climsr.step.*``, ``climsr.gan.*``,
``climsr.fit.*``) and :func:`count` a unit of it, both into the recorder that
:func:`recording` turns on. Off, which is the default, a span is one shared
no-op context and a count returns at once: a flag test each, no allocation, no
clock read. On, a span keeps its name, thread, start and end in
``time.time_ns()`` (the clock of a ``torch.profiler`` trace's
``trace_start_ns()`` and its events' ``start_ns()``), the span it ran under
and a key (a step, group or month); while a ``torch.profiler`` runs, it also
opens a ``record_function`` range of its name, inside its own interval, so a
profile's timeline shows it.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)


def profiler(device):
    """A ``torch.profiler.profile`` over the CPU and, on a card, CUDA (not started)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _self_device_us(event) -> float:
    """An averaged event's self device time in us: the field is
    ``self_device_time_total`` in newer torch, ``self_cuda_time_total`` before."""
    for field in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, field, None)
        if value is not None:
            return float(value)
    return 0.0


def aggregate_device_ops(prof) -> Optional[Dict[str, Tuple[float, int]]]:
    """op or kernel name -> (total self time in seconds, event count).

    On a card: the device events (kernels, copies, memsets) of the trace,
    each kernel under its own name. Without device events (the CPU): every
    op's self CPU time. None when the trace holds nothing.
    """
    import torch

    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    totals: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))
    if device:
        for e in device:
            secs, cnt = totals[e.key]
            totals[e.key] = (secs + _self_device_us(e) * 1e-6, cnt + e.count)
    else:
        for e in events:
            if e.self_cpu_time_total > 0:
                secs, cnt = totals[e.key]
                totals[e.key] = (secs + e.self_cpu_time_total * 1e-6, cnt + e.count)
    return dict(totals) or None


_ASYNC_PREFIXES = ("copy-start", "copy-done", "all-reduce-start", "all-gather-start",
                   "collective-permute-start", "send", "recv", "async")


def _is_async_span(op: str) -> bool:
    return op.lstrip("%").startswith(_ASYNC_PREFIXES)


def format_op_table(totals: Dict[str, Tuple[float, int]], top: int = 40) -> str:
    """AdvancedProfiler-style table: ops ranked by total device time.

    Async DMA/collective spans (copy-start etc.) OVERLAP compute — their
    durations measure transfer latency, not occupied core time — so they are
    aggregated into one summary row instead of polluting the compute ranking.
    """
    compute = {k: v for k, v in totals.items() if not _is_async_span(k)}
    async_secs = sum(t for k, (t, _) in totals.items() if _is_async_span(k))
    async_cnt = sum(c for k, (_, c) in totals.items() if _is_async_span(k))
    grand = sum(t for t, _ in compute.values()) or 1.0
    rows = sorted(compute.items(), key=lambda kv: -kv[1][0])[:top]
    width = max((len(n) for n, _ in rows), default=10)
    width = min(width, 72)
    lines = [f"  {'op':<{width}}  {'total':>10}  {'count':>7}  {'mean':>9}  {'%':>5}"]
    for op, (secs, cnt) in rows:
        shown = op if len(op) <= width else op[: width - 1] + "…"
        lines.append(
            f"  {shown:<{width}}  {secs * 1e3:8.2f}ms  {cnt:7d}  {secs / max(cnt, 1) * 1e6:7.1f}us  {secs / grand * 100:4.1f}"
        )
    lines.append(f"  {'TOTAL (compute events)':<{width}}  {grand * 1e3:8.2f}ms")
    if async_cnt:
        lines.append(
            f"  {'async DMA/collective spans (overlap compute)':<{width}}  "
            f"{async_secs * 1e3:8.2f}ms  {async_cnt:7d}"
        )
    return "\n".join(lines)


def advanced_profile_report(prof, top: int = 40) -> Optional[str]:
    """The op table of a finished ``torch.profiler`` trace, under a line
    naming the torch version and what was summed; None for an empty trace."""
    import torch

    totals = aggregate_device_ops(prof)
    if not totals:
        return None
    on_card = any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.key_averages())
    what = "self device time by kernel" if on_card else "self CPU time by op (no device events)"
    return f"  torch {torch.__version__}: {what}\n" + format_op_table(totals, top=top)


# ---------------------------------------------------------------------------
# Spans and counters


@dataclass
class Span:
    """One recorded interval of the program's work. ``parent`` is the index
    in :attr:`Recorder.spans` of the span it ran under (None at the top);
    ``end_ns`` is 0 while the span is open."""

    name: str
    thread: int  # threading.get_native_id()
    start_ns: int
    end_ns: int
    parent: Optional[int]
    key: Optional[int]
    index: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The spans and counters of one :func:`recording`: ``spans`` in the
    order they opened, ``counts`` by name."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.thread = threading.get_native_id()
        self._lock = threading.Lock()
        self._open = threading.local()  # each thread's stack of open spans

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_active: Optional[Recorder] = None


class _Open:
    __slots__ = ("rec", "name", "key", "parent", "span", "range")

    def __init__(self, rec: Recorder, name: str, key: Optional[int], parent: Optional[Span]):
        self.rec, self.name, self.key, self.parent = rec, name, key, parent

    def __enter__(self) -> Span:
        rec = self.rec
        stack = getattr(rec._open, "stack", None)
        if stack is None:
            stack = rec._open.stack = []
        parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
        s = Span(self.name, threading.get_native_id(), time.time_ns(), 0,
                 None if parent is None else parent.index, self.key, -1)
        with rec._lock:
            s.index = len(rec.spans)
            rec.spans.append(s)
        stack.append(s)
        self.span = s
        self.range = None
        import torch.autograd.profiler as autograd_profiler

        if autograd_profiler._is_profiler_enabled:
            self.range = autograd_profiler.record_function(self.name)
            self.range.__enter__()
        return s

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        self.rec._open.stack.pop()
        return False


def span(name: str, key: Optional[int] = None, parent: Optional[Span] = None):
    """A context over one stage of the work, recorded while :func:`recording`
    is on (it yields the :class:`Span`, else None). ``parent`` defaults to the
    innermost span open on this thread; a stage that runs on another thread
    for a span (a writer's part of a group) names that span."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name, key, parent)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while :func:`recording` is on."""
    rec = _active
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters over the block; yields the :class:`Recorder`.
    Inside another recording it yields that one, which stays on."""
    global _active
    if _active is not None:
        yield _active
        return
    _active = Recorder()
    try:
        yield _active
    finally:
        _active = None
