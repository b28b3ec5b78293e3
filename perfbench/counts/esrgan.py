"""Operations of the ESRGAN family with the SRCNN fusion head, counted from
the configuration's shapes.

What is counted is the model's own convolutions, each 3x3 (or 9x9, 1x1, 5x5)
at the resolution the published model runs it: not what the port launches.
The phase form of the upsampling convs, the halo the kernels recompute, the
sweep's tile overlap and padding and any recompute are left out, so a share of
the peak from these counts cannot pass 100% for work the model does not need.
"""
from __future__ import annotations

from perfbench.peaks import rdb_macs_per_px


def macs_per_lr_px(gen: dict) -> int:
    """Multiply-adds of one forward pass per LR input pixel (flagship:
    5,775,040)."""
    nf, nb, gc = gen["nf"], gen["nb"], gen["gc"]
    cin, cout, s = gen["in_channels"], gen["out_channels"], gen["scaling_factor"]
    hr = s * s
    first = 9 * cin * nf
    trunk = 3 * nb * rdb_macs_per_px(nf, gc) + 9 * nf * nf
    # a 3x3 conv after each nearest x2: at 2x2 the LR pixels, then at 4x4
    ups = 9 * nf * nf * (4 + 16) if s == 4 else 9 * nf * nf * 4
    tail = 9 * nf * nf * hr + 9 * nf * cout * hr
    head = (81 * (cout + 2) * 64 + 64 * 32 + 25 * 32 * cout) * hr
    return first + trunk + ups + tail + head


def forward_flops(gen: dict, n: int, h: int, w: int) -> float:
    """Operations of one forward pass over n LR frames of h x w."""
    return 2.0 * macs_per_lr_px(gen) * n * h * w


def train_step_flops(gen: dict, batch: int, lr_size: int) -> float:
    """One pixel-loss training step: the forward and its backward, counted as
    three forwards (input and weight gradients each cost one)."""
    return 3.0 * forward_flops(gen, batch, lr_size, lr_size)


def discriminator_macs(hr: int, cin: int = 1, width: int = 64, blocks: int = 4) -> int:
    """The ESRGAN discriminator on one hr x hr image: per block a 3x3 conv at
    the block's side and a 3x3 conv of stride 2, then two unpadded 3x3 convs
    and the two linears."""
    macs, side, c, f = 0, hr, cin, width
    for _ in range(blocks):
        half = (side - 1) // 2 + 1
        macs += 9 * c * f * side * side + 9 * f * f * half * half
        side, c, f = half, f, 2 * f
    macs += 9 * c * c * ((side - 2) ** 2 + (side - 4) ** 2)
    return macs + c * (side - 4) ** 2 * 100 + 100


VGG19_TO_CONV5_4 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512]


def vgg_macs(hr: int) -> int:
    """VGG19's features through conv5_4 on one three-channel hr x hr image."""
    macs, side, c = 0, hr, 3
    for item in VGG19_TO_CONV5_4:
        if item == "M":
            side //= 2
            continue
        macs += 9 * c * item * side * side
        c = item
    return macs


def gan_step_flops(gen: dict, batch: int, lr_size: int) -> float:
    """One relativistic GAN step: the generator's forward and backward (three
    forwards); the discriminator's four forwards, the input gradient through
    D(sr) for G, and the weight and input gradients of D's two forwards in its
    own sub-step (nine forwards in all); two VGG19 forwards without a gradient."""
    hr = lr_size * gen["scaling_factor"]
    per_image = 3 * macs_per_lr_px(gen) * lr_size * lr_size + 9 * discriminator_macs(hr) + 2 * vgg_macs(hr)
    return 2.0 * batch * per_image
