"""The receptive-field blocks' share of their roofline over the traced
steps: each ``climsr.rfb.block`` span's bound (``counts/rfb_esrgan.py``
``rfb_fwd_bound_s``: its block's operations at the bf16 dense peak or its
input and output at 3.35 TB/s, whichever is longer, at the cell's batch and
that block's width and resolution), summed over the spans, over the device
time launched inside them. None without them."""
from perfbench.counts.rfb_esrgan import rfb_fwd_bound_s

UNIT, LAYER, MOVES = "%", "kernels", "train_samples_per_s"
DTYPES = {"bf16": "bfloat16", "fp32": "float32"}


def read(out, cell):
    rfb = out.notes.get("rfb") or {}
    if not rfb.get("block_spans") or not rfb.get("block_device_s"):
        return None
    gen, tr = cell.config["generator"], cell.traffic
    lr = tr["hr_size"] // tr["scale"]
    dtype = DTYPES[cell.config["precision"]]
    bound_s = sum(n * rfb_fwd_bound_s(gen, int(key), tr["batch_size"], lr, lr, dtype) for key, n in rfb["keys"].items())
    return 100.0 * bound_s / rfb["block_device_s"]
