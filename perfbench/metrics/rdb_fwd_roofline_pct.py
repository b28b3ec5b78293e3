"""Kernel A's share of its roofline over a traced sweep: each ``fused_rdb``
call's bound (``peaks.rdb_bound_ms``) over the device time of what it launched."""
from perfbench.readout import rdb_roofline_pct

UNIT, LAYER, MOVES = "%", "kernels", "sweep_months_per_s"


def read(out, cell):
    return rdb_roofline_pct(out, ("A",)) if out.kind == "sweep" else None
