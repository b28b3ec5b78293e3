"""The yardstick's arithmetic: an H100's published peaks and the least time a
piece of work can take on it.

Frozen copies of ``chip_smoke.py``'s ``PEAK_FLOPS``, ``PEAK_BYTES_PER_S``,
``bound``, ``rdb_macs_per_px``, ``rdb_bound_ms`` and phase 6's B1/B2 rule
(``phase_train_kernels``), taken so that later changes to that script or to
the port cannot move the benchmark's scale. Counts take shapes, not tensors.
"""
from __future__ import annotations

# H100 SXM published dense peaks at 700 W (NVIDIA data sheet), by element type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound(flops: float, moved: float, dtype: str) -> tuple:
    """(ms, "operations"|"bytes"): the least time on an H100, the larger of
    the operations over the peak rate of ``dtype`` and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rdb_macs_per_px(nf: int, gc: int) -> int:
    """Multiply-adds of one residual dense block per pixel: four growth convs
    and the fusing conv, all 3x3."""
    return 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)


def _rdb_weight_bytes(nf: int, gc: int) -> int:
    """The packed f32 weights and biases of one block, read once."""
    return 4 * (rdb_macs_per_px(nf, gc) + 4 * gc + nf)


def rdb_bound_ms(n: int, h: int, w: int, nf: int, gc: int, with_x0: bool, dtype: str) -> tuple:
    """Kernel A's bound: its operations, and x, x0, out once and the packed f32 weights."""
    px = n * h * w
    moved = px * nf * ELEMENT_BYTES[dtype] * (3 if with_x0 else 2) + _rdb_weight_bytes(nf, gc)
    return bound(2.0 * rdb_macs_per_px(nf, gc) * px, moved, dtype)


def rdb_train_bounds_ms(n: int, h: int, w: int, nf: int, gc: int, with_x0: bool, dtype: str) -> tuple:
    """(B1's bound, B2's bound), each (ms, bound by). Phase 6's rule: B1 does
    the forward's operations and reads x (and x0 where the outer residual is
    folded in) and writes out and the saved features once; B2 does twice the
    forward's operations (dX and dW) and reads the features and g and writes
    dx once; both read the weights once. Phase 6 stated it for x0 absent."""
    px = n * h * w
    es = ELEMENT_BYTES[dtype]
    total = nf + 4 * gc
    macs = rdb_macs_per_px(nf, gc)
    wbytes = _rdb_weight_bytes(nf, gc)
    fwd_bytes = px * es * (nf * (3 if with_x0 else 2) + total) + wbytes
    bwd_bytes = px * es * (total + 2 * nf) + wbytes
    return bound(2.0 * macs * px, fwd_bytes, dtype), bound(4.0 * macs * px, bwd_bytes, dtype)
