"""What the per-layer metric readers share: the shares of the bf16 dense peak, the device idle share and the RDB spans' roofline."""
from __future__ import annotations

from typing import Optional, Sequence

from perfbench.peaks import PEAK_FLOPS, rdb_bound_ms, rdb_train_bounds_ms
from perfbench.trace import parse_rdb_name


def mfu_pct(out, kind: str) -> Optional[float]:
    """The model's operations in the untraced window over its wall, as a share of the bf16 dense peak."""
    if out.kind != kind or not out.window_s or not out.flops:
        return None
    return 100.0 * out.flops / out.window_s / PEAK_FLOPS["bfloat16"]


def idle_pct(out, kind: str) -> Optional[float]:
    """100% less the share of the device-only pass's window in which any device operation ran."""
    if out.kind != kind or out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)


def rdb_roofline_pct(out, kinds: Sequence[str]) -> Optional[float]:
    """Sum of each RDB call's bound over the device time of the kernels
    launched inside those calls, for the calls of ``kinds`` (A, B1, B2)."""
    if out.trace is None:
        return None
    bound_s, device_s = 0.0, 0.0
    for name, seconds in out.trace.rdb_calls:
        kind, (n, c, h, w), x0, gc, dtype = parse_rdb_name(name)
        if kind not in kinds:
            continue
        if kind == "A":
            ms = rdb_bound_ms(n, h, w, c, gc, x0, dtype)[0]
        else:
            b1, b2 = rdb_train_bounds_ms(n, h, w, c, gc, x0, dtype)
            ms = (b1 if kind == "B1" else b2)[0]
        bound_s += ms / 1e3
        device_s += seconds
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
