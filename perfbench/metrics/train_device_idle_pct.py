"""The share of the traced training steps in which no operation ran on the
device, from their pass traced with device activity alone (``trace.device_pass``)."""
from perfbench.readout import idle_pct

UNIT, LAYER, MOVES = "%", "device", "train_samples_per_s"


def read(out, cell):
    return idle_pct(out, "train")
