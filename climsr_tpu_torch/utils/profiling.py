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
"""
from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Optional, Tuple

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
