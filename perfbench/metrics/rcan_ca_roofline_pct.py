"""The channel attention's share of its roofline over the traced steps: the
bytes every attention of a forward must move (``counts/rcan.py``
``ca_fwd_bytes`` at the cell's batch and precision) at 3.35 TB/s, times the
forwards the ``climsr.rcan.ca`` spans cover, over the device time launched
inside those spans. None without them."""
from perfbench.counts.rcan import ca_fwd_bytes
from perfbench.peaks import PEAK_BYTES_PER_S

UNIT, LAYER, MOVES = "%", "kernels", "train_samples_per_s"
DTYPES = {"bf16": "bfloat16", "fp32": "float32"}


def read(out, cell):
    ca = out.notes.get("rcan_ca") or {}
    if not ca.get("ca_spans") or not ca.get("ca_device_s"):
        return None
    gen, tr = cell.config["generator"], cell.traffic
    lr = tr["hr_size"] // tr["scale"]
    forwards = ca["ca_spans"] / (gen["n_resgroups"] * gen["n_resblocks"])
    moved = forwards * ca_fwd_bytes(gen, tr["batch_size"], lr, lr, DTYPES[cell.config["precision"]])
    return 100.0 * moved / PEAK_BYTES_PER_S / ca["ca_device_s"]
