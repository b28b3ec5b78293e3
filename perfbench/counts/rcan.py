"""Operations and bytes of the RCAN family with the SRCNN fusion head,
counted from the configuration's shapes.

As ``counts/esrgan.py``: the model's own convolutions at the resolution the
published model runs them, not what the port launches. The channel
attention's two 1x1 convs act on the pooled (N, C, 1, 1) vector, so they are
counted per image, not per pixel.
"""
from __future__ import annotations

from perfbench.peaks import ELEMENT_BYTES


def macs_per_lr_px(gen: dict) -> int:
    """Multiply-adds of one forward pass per LR input pixel, the attention's
    1x1 convs left out (published widths: 16,193,728)."""
    nf, cin, cout, s = gen["n_feats"], gen["in_channels"], gen["out_channels"], gen["scaling_factor"]
    groups, blocks = gen["n_resgroups"], gen["n_resblocks"]
    conv = 9 * nf * nf
    head = 9 * cin * nf
    trunk = (2 * blocks + 1) * groups * conv + conv  # two convs an RCAB, one a group, one after the groups
    # a 3x3 conv to 4 nf before each shuffle of 2: at 1x1 the LR pixels, then at 2x2, ...
    ups = sum(4 * conv * 4 ** k for k in range(s.bit_length() - 1))
    hr = s * s
    out = 9 * nf * cout * hr
    fusion = (81 * (cout + 2) * 64 + 64 * 32 + 25 * 32 * cout) * hr
    return head + trunk + ups + out + fusion


def ca_macs_per_image(gen: dict) -> int:
    """The channel attentions' 1x1 convs over one image's pooled vectors (512
    an attention at 64 features, reduction 16)."""
    nf = gen["n_feats"]
    return gen["n_resgroups"] * gen["n_resblocks"] * 2 * nf * (nf // gen["reduction"])


def forward_flops(gen: dict, n: int, h: int, w: int) -> float:
    """Operations of one forward pass over n LR frames of h x w."""
    return 2.0 * (macs_per_lr_px(gen) * n * h * w + ca_macs_per_image(gen) * n)


def train_step_flops(gen: dict, batch: int, lr_size: int) -> float:
    """One pixel-loss training step: three forwards (the input and weight
    gradients each cost one)."""
    return 3.0 * forward_flops(gen, batch, lr_size, lr_size)


def ca_fwd_bytes(gen: dict, n: int, h: int, w: int, dtype: str = "bfloat16") -> int:
    """The bytes every channel attention of one forward must move over n LR
    frames of h x w: the pool reads the features once, the scale reads them
    and writes its output (3 x N C H W elements each); the 1x1 convs' vectors
    and weights are left out (under 0.1% at 64 features)."""
    return gen["n_resgroups"] * gen["n_resblocks"] * 3 * n * gen["n_feats"] * h * w * ELEMENT_BYTES[dtype]
