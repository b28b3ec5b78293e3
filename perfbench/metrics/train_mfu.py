"""The training window's model operations (three forwards a step at the
batch, ``counts/<family>.py``) over its wall, as a share of 989 TFLOP/s."""
from perfbench.readout import mfu_pct

UNIT, LAYER, MOVES = "%", "step", "train_samples_per_s"


def read(out, cell):
    return mfu_pct(out, "train")
