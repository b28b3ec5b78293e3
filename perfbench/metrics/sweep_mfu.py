"""The sweep's model operations (2 x MACs per LR pixel x 360 x 720 a month,
``counts/<family>.py``) over the untraced window's wall, as a share of 989
TFLOP/s."""
from perfbench.readout import mfu_pct

UNIT, LAYER, MOVES = "%", "step", "sweep_months_per_s"


def read(out, cell):
    return mfu_pct(out, "sweep")
