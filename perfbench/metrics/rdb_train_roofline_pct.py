"""Kernels B1 and B2's share of their roofline over the traced steps: each
``fused_rdb_fwd_save`` and ``fused_rdb_bwd`` call's bound (phase 6's rule,
``peaks.rdb_train_bounds_ms``) over the device time of what it launched."""
from perfbench.readout import rdb_roofline_pct

UNIT, LAYER, MOVES = "%", "kernels", "train_samples_per_s"


def read(out, cell):
    return rdb_roofline_pct(out, ("B1", "B2")) if out.kind == "train" else None
