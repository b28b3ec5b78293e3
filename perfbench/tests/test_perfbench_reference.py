"""The plain reference on tiny hand-checked cases, and held against the port at a small size."""
import numpy as np
import pytest
import torch

from perfbench.reference import esrgan, sweep, train

TINY = dict(name="esrgan", nf=8, nb=1, gc=4, in_channels=3, out_channels=1, scaling_factor=4)


def _zeros(gen):
    return {k: torch.zeros(s) for k, s in esrgan.param_shapes(gen)}


def test_zero_weights_by_hand():
    p = _zeros(TINY)
    x = torch.randn(2, 8, 5, 6)
    assert torch.equal(esrgan.rdb(x, p, "RRDB_trunk.0.RDB1", esrgan.f32_conv), x)
    p["srcnn.conv3.bias"] = torch.tensor([0.75])
    out = esrgan.forward(p, TINY, torch.randn(2, 3, 4, 5), torch.randn(2, 1, 16, 20), torch.ones(2, 1, 16, 20))
    assert out.shape == (2, 1, 16, 20) and torch.equal(out, torch.full_like(out, 0.75))


def test_rdb_by_hand():
    # one pixel, nf=1, gc=1, centre taps only: h1 = lrelu(a x), h2 = lrelu(b x), ...
    gen = dict(TINY, nf=1, gc=1)
    p = {}
    for k in range(1, 6):
        cin, cout = (1 + (k - 1), 1) if k < 5 else (5, 1)
        w = torch.zeros(cout, cin, 3, 3)
        w[0, 0, 1, 1] = 2.0 if k < 5 else 1.0  # each conv reads only x; conv5 sums x alone
        p[f"b.conv{k}.weight"], p[f"b.conv{k}.bias"] = w, torch.zeros(cout)
    x = torch.full((1, 1, 1, 1), -1.0)
    # conv5 reads x once: out = 0.2 * x + x
    assert esrgan.rdb(x, p, "b", esrgan.f32_conv).item() == pytest.approx(-1.2)
    assert len(esrgan.param_shapes(gen)) == len(esrgan.param_shapes(TINY))


def test_matches_the_port_in_float32():
    from climsr_tpu_torch.models import create_generator

    p = esrgan.seeded_params(TINY, 3, torch.device("cpu"))
    model = create_generator("esrgan", device="cpu", in_channels=3, out_channels=1, nf=8, nb=1, gc=4)
    model.load_state_dict(p, strict=True)
    g = torch.Generator().manual_seed(0)
    lr, elev = torch.randn(2, 3, 6, 7, generator=g), torch.randn(2, 1, 24, 28, generator=g)
    mask = (torch.rand(2, 1, 24, 28, generator=g) > 0.3).float()
    with torch.no_grad():
        got = model(lr, elev, mask)
    ref = esrgan.forward(p, TINY, lr, elev, mask)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_fp8_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = esrgan._fp8(x)
    assert 0 < (q - x).abs().max().item() <= 3 * 2 ** -3
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_augment_by_hand():
    t = torch.tensor([[1.0, 2.0], [3.0, 4.0]])[None, None]
    flags = lambda v, h, k: (torch.tensor([v]), torch.tensor([h]), torch.tensor([k]))  # noqa: E731
    assert train.augment(t, flags(True, False, 0))[0, 0].tolist() == [[3, 4], [1, 2]]
    assert train.augment(t, flags(False, True, 0))[0, 0].tolist() == [[2, 1], [4, 3]]
    assert train.augment(t, flags(False, False, 1))[0, 0].tolist() == [[2, 4], [1, 3]]


@pytest.mark.parametrize("on", [(True, True, True), (False, False, False), (False, True, True)])
def test_flags_are_the_ports_draws(on):
    from climsr_tpu_torch.ops.augment import draw_flags, step_generator

    transforms = dict(zip(("v_flip", "h_flip", "random_90_rotation"), on))
    ref = train.step_flags(64, 2 ** 33 + 5, 7, torch.device("cpu"), transforms)
    got = draw_flags(64, step_generator(2 ** 33 + 5, 7, torch.device("cpu")), *on)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert any(f.any() for f in ref) == any(on)


def test_schedule_and_adamw_by_hand():
    kw = dict(pct_start=0.05, div_factor=2.0, final_div_factor=100.0, base_momentum=0.85, max_momentum=0.95)
    assert train.one_cycle(0, 4500, 1e-4, **kw) == (pytest.approx(5e-5), pytest.approx(0.95))
    up = int(np.ceil(0.05 * 4500)) - 1
    assert train.one_cycle(up, 4500, 1e-4, **kw) == (pytest.approx(1e-4), pytest.approx(0.85))
    assert train.one_cycle(4499, 4500, 1e-4, **kw)[0] == pytest.approx(5e-7, rel=1e-3)
    p = {"w": torch.tensor([1.0])}
    out = train.adamw(p, {"w": torch.tensor([0.5])}, {}, 1, 0.1, 0.9, 0.999, 0.0, 0.01)
    assert out["w"].item() == pytest.approx(1.0 * (1 - 0.001) - 0.1)


def test_epoch_order_is_a_permutation():
    order = train.epoch_order(50, 2 ** 31 + 3, 0)
    assert sorted(order.tolist()) == list(range(50))
    assert not np.array_equal(order, train.epoch_order(50, 2 ** 31 + 3, 1))


def test_tiff_reader_and_gap(tmp_path):
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    a[0, 0] = np.nan
    write_geotiff(tmp_path / "a.tif", a, GeoProfile.global_grid(3, 4, nodata=np.nan))
    got = sweep.read_tiff(str(tmp_path / "a.tif"))
    assert np.array_equal(np.isnan(got), np.isnan(a)) and np.array_equal(got[1:], a[1:])
    land = ~np.isnan(a)
    ref = np.where(land, a + 0.5, np.nan)
    assert sweep.month_gap(got, ref, land, 0.0, 10.0) == (pytest.approx(0.1), 0)
    land[0, 1] = False
    assert sweep.month_gap(got, ref, land, 0.0, 10.0)[1] == 1


def test_static_inputs_by_hand():
    mask = np.array([[1.0, np.nan], [1.0, 1.0]], np.float32).repeat(2, 0).repeat(2, 1)
    elev = np.arange(16, dtype=np.float32).reshape(4, 4)
    s = sweep.static_inputs(elev, mask, 2)
    assert s["mask_lr"].tolist() == [[1, 0], [1, 1]]
    assert s["elev"][0, 2] == 0.0 and s["elev"].max() == pytest.approx(1.0) and s["elev"][0, 0] == pytest.approx(-1.0)
