"""Faults planted in RFB-ESRGAN's receptive-field blocks under the timed
path, each a context manager that patches the port (as ``faults.py``'s):

- ``undilated``: the RFB branches' dilated 3x3 convs run at dilation 1 (their padding 1, so the shapes hold);
- ``dense_concat_short``: each RFDB's last RFB reads zeros where its dense
  concatenation's last feature (the fourth RFB's output) should be.
"""
import torch
import torch.nn.functional as F
from faults import _patched


def undilated():
    from climsr_tpu_torch.models.common import TorchConv

    forward = TorchConv.forward

    def at_dilation_1(self, x):
        if self.dilation == (1, 1):
            return forward(self, x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, padding=tuple(k // 2 for k in self.kernel_size))

    return _patched(TorchConv, "forward", at_dilation_1)


def dense_concat_short():
    from climsr_tpu_torch.models.rfb_esrgan import ReceptiveFieldDenseBlock

    def forward(self, x):
        feats = [x]
        for m in range(1, 5):
            feats.append(getattr(self, f"RFB{m}")(torch.cat(feats, dim=1)))
        feats[-1] = torch.zeros_like(feats[-1])
        return self.RFB5(torch.cat(feats, dim=1)) * self.scale_ratio + x

    return _patched(ReceptiveFieldDenseBlock, "forward", forward)
