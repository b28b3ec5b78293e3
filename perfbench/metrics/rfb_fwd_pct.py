"""The receptive-field blocks' share of RFB-ESRGAN's forward on the device:
the device time launched inside the ``climsr.rfb.block`` spans over that
launched inside the ``climsr.step.forward`` spans, over the traced steps'
span pass (``entries/train_rfb.py`` ``rfb_readings``). None without those spans."""
UNIT, LAYER, MOVES = "%", "model", "train_samples_per_s"


def read(out, cell):
    rfb = out.notes.get("rfb") or {}
    if not rfb.get("block_spans") or not rfb.get("forward_device_s"):
        return None
    return 100.0 * rfb["block_device_s"] / rfb["forward_device_s"]
