"""The yardstick's counts against hand counts."""
import pytest

from perfbench.counts import esrgan
from perfbench.peaks import bound, rdb_bound_ms, rdb_macs_per_px, rdb_train_bounds_ms

FLAGSHIP = dict(name="esrgan", nf=64, nb=11, gc=16, in_channels=3, out_channels=1, scaling_factor=4)
PAPER = dict(FLAGSHIP, nb=23, gc=32)


def test_rdb_macs_by_hand():
    # nf=4, gc=2: growth convs 4->2, 6->2, 8->2, 10->2 and 12->4, nine taps each
    assert rdb_macs_per_px(4, 2) == 9 * (4 * 2 + 6 * 2 + 8 * 2 + 10 * 2 + 12 * 4)
    assert rdb_macs_per_px(64, 16) == 124_416
    assert rdb_macs_per_px(64, 32) == 239_616


def test_small_esrgan_by_hand():
    gen = dict(FLAGSHIP, nf=4, nb=1, gc=2)
    rdb = 9 * (4 * 2 + 6 * 2 + 8 * 2 + 10 * 2 + 12 * 4)
    by_hand = (9 * 3 * 4  # conv_first
               + 3 * rdb + 9 * 4 * 4  # one RRDB, trunk_conv
               + 9 * 4 * 4 * 4 + 9 * 4 * 4 * 16  # upconv1 at 2x2, upconv2 at 4x4 per LR pixel
               + 9 * 4 * 4 * 16 + 9 * 4 * 1 * 16  # HRconv, conv_last
               + (81 * 3 * 64 + 64 * 32 + 25 * 32) * 16)  # the SRCNN fusion head at HR
    assert esrgan.macs_per_lr_px(gen) == by_hand


def test_published_configurations():
    assert esrgan.macs_per_lr_px(FLAGSHIP) == 5_775_040
    assert esrgan.macs_per_lr_px(PAPER) == 1728 + 69 * 239_616 + 36_864 + 737_280 + 589_824 + 9216 + 294_400
    assert esrgan.macs_per_lr_px(PAPER) == pytest.approx(18.20e6, rel=1e-3)
    # a pre-training step at batch 192: 6.81 TFLOP; a whole-globe month: 3.0 TFLOP
    assert esrgan.train_step_flops(FLAGSHIP, 192, 32) == pytest.approx(6.81e12, rel=1e-3)
    assert esrgan.forward_flops(FLAGSHIP, 1, 360, 720) == pytest.approx(2.994e12, rel=1e-3)


def test_bounds():
    ms, by = bound(989e12, 1.0, "bfloat16")
    assert (ms, by) == (pytest.approx(1e3), "operations")
    ms, by = bound(1.0, 3.35e12, "float32")
    assert (ms, by) == (pytest.approx(1e3), "bytes")
    # kernel A at the sweep's call (16 x 64 x 128 x 128, gc=16, bf16): 0.0660 ms of operations
    ms, by = rdb_bound_ms(16, 128, 128, 64, 16, True, "bfloat16")
    assert by == "operations" and ms == pytest.approx(0.0660, abs=5e-4)
    # phase 6's B1 and B2 at 192 x 64 x 32 x 32: 0.0495 and 0.0989 ms (gc=16), 0.0953 and 0.1905 (gc=32)
    (b1, _), (b2, _) = rdb_train_bounds_ms(192, 32, 32, 64, 16, False, "bfloat16")
    assert (b1, b2) == (pytest.approx(0.0495, abs=5e-4), pytest.approx(0.0989, abs=5e-4))
    (b1, _), (b2, _) = rdb_train_bounds_ms(192, 32, 32, 64, 32, False, "bfloat16")
    assert (b1, b2) == (pytest.approx(0.0953, abs=5e-4), pytest.approx(0.1905, abs=5e-4))
