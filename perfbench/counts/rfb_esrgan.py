"""Operations and bytes of the RFB-ESRGAN generator, counted from the
configuration's shapes.

As ``counts/esrgan.py``: the model's own convolutions at the resolution the
published model runs them, not what the port launches. The features (64)
and growth (32) are fixed in the model; the configuration gives the depths,
the channels in and out and the scale. An RFB's convs (``rfb_convs``):
a 1x1 shortcut, four branches of 1x1, (1,3), (3,1) and 3x3 convs at a
quarter of the input's channels or less, and a 1x1 merge.
"""
from __future__ import annotations

from typing import Dict, Tuple

from perfbench.peaks import ELEMENT_BYTES, bound, rdb_macs_per_px
from perfbench.reference.rfb_esrgan import GC, NF, rfb_prefixes, rfb_convs, upsampling_stages


def rfb_macs_per_px(cin: int, cout: int) -> int:
    """Multiply-adds of one RFB per pixel of its own resolution (64 -> 64: 23,392)."""
    return sum(o * i * kh * kw for _, (o, i, kh, kw), _, _ in rfb_convs(cin, cout))


def rfb_blocks(gen: dict) -> Dict[int, Tuple[int, int, int]]:
    """Span key (the block's index in the generator) -> (cin, cout, its
    pixels per LR pixel): the trunk's at 1, the middle one at 1, then per
    upsampling stage of 4 one after the nearest x2 (4 ** stage) and one after
    the shuffle (16 ** ...)."""
    out = {}
    for key, (prefix, cin, cout) in enumerate(rfb_prefixes(gen)):
        area = 1
        if prefix.startswith("upsampling."):
            index = int(prefix.split(".")[1])
            stage, after_shuffle = index // 6, index % 6 == 5
            area = 16 ** stage * (16 if after_shuffle else 4)
        out[key] = (cin, cout, area)
    return out


def macs_per_lr_px(gen: dict) -> int:
    """Multiply-adds of one forward pass per LR input pixel (published widths: 22,669,344)."""
    first = 9 * gen["in_channels"] * NF
    trunk = 3 * gen["num_rrdb_blocks"] * rdb_macs_per_px(NF, GC)
    rfbs = sum(rfb_macs_per_px(cin, cout) * area for cin, cout, area in rfb_blocks(gen).values())
    # each stage's 3x3 conv to 4 x 64 at the nearest x2's resolution
    ups = sum(9 * NF * 4 * NF * 4 * 16 ** b for b in range(upsampling_stages(gen)))
    hr = gen["scaling_factor"] ** 2
    tail = 9 * NF * NF * hr + 9 * NF * gen["out_channels"] * hr
    return first + trunk + rfbs + ups + tail


def forward_flops(gen: dict, n: int, h: int, w: int) -> float:
    """Operations of one forward pass over n LR frames of h x w."""
    return 2.0 * macs_per_lr_px(gen) * n * h * w


def train_step_flops(gen: dict, batch: int, lr_size: int) -> float:
    """One pixel-loss training step: the forward and its backward, counted as
    three forwards (input and weight gradients each cost one)."""
    return 3.0 * forward_flops(gen, batch, lr_size, lr_size)


def rfb_fwd_bound_s(gen: dict, key: int, n: int, h: int, w: int, dtype: str = "bfloat16") -> float:
    """The least time of one forward call of the RFB ``key`` over n LR frames
    of h x w on an H100: the larger of its operations at the dense peak of
    ``dtype`` and its input read once and output written once at 3.35 TB/s
    (its weights, under 0.1% of that, left out)."""
    cin, cout, area = rfb_blocks(gen)[key]
    px = n * h * w * area
    ms, _ = bound(2.0 * rfb_macs_per_px(cin, cout) * px, px * (cin + cout) * ELEMENT_BYTES[dtype], dtype)
    return ms / 1e3
