"""The channel attention's share of RCAN's forward on the device: the device
time launched inside the ``climsr.rcan.ca`` spans over that launched inside
the ``climsr.step.forward`` spans, over the traced steps' span pass
(``entries/train_rcan.py`` ``ca_readings``). None without those spans."""
UNIT, LAYER, MOVES = "%", "model", "train_samples_per_s"


def read(out, cell):
    ca = out.notes.get("rcan_ca") or {}
    if not ca.get("ca_spans") or not ca.get("forward_device_s"):
        return None
    return 100.0 * ca["ca_device_s"] / ca["forward_device_s"]
