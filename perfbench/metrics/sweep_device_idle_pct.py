"""The share of a traced sweep in which no operation ran on the device, from
its pass traced with device activity alone (``trace.device_pass``)."""
from perfbench.readout import idle_pct

UNIT, LAYER, MOVES = "%", "device", "sweep_months_per_s"


def read(out, cell):
    return idle_pct(out, "sweep")
