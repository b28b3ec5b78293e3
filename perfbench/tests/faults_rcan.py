"""Faults planted in RCAN's channel attention under the timed path, each a
context manager that patches the port (as ``faults.py``'s):

- ``no_channel_attention``: every attention is left out, its scale 1;
- ``pool_one_row``: the attention's pool takes the mean over the frame's first row alone.
"""
from faults import _patched


def no_channel_attention():
    from climsr_tpu_torch.models.rcan import CALayer

    return _patched(CALayer, "forward", lambda self, x: x)


def pool_one_row():
    from climsr_tpu_torch.models.common import global_avg_pool
    from climsr_tpu_torch.models.rcan import CALayer

    return _patched(CALayer, "pool", lambda self, x: global_avg_pool(x[:, :, :1]))
