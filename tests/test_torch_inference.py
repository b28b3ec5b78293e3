# -*- coding: utf-8 -*-
"""The port's inference path (climsr_tpu_torch.inference, ops.pack12, io,
datasets) against the JAX package's, on the CPU.

Same synthetic files and numpy inputs go through both; the small ESRGAN's
weights are carried over with ``state_dict_from_flax``. Tolerances are stated
where they are not exact: f32 model outputs agree to 1e-4 of their range; a
12-bit or f16 readback adds its own quantization step.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import climsr_tpu.consts as jconsts
from climsr_tpu.inference import datasets as jax_datasets
from climsr_tpu.inference.run import inference_on_full_images as jax_inference_on_full_images
from climsr_tpu.inference.tiled import TiledSR as JaxTiledSR
from climsr_tpu.io import geotiff as jax_geotiff
from climsr_tpu.io import netcdf as jax_netcdf
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.ops.pack12 import pack12 as jax_pack12
from climsr_tpu_torch.data.normalization import StandardScaler
from climsr_tpu_torch.inference import datasets
from climsr_tpu_torch.inference.run import (
    inference_on_full_images,
    make_generator_fn,
    transform_tiff_files_to_net_cdf,
)
from climsr_tpu_torch.inference.tiled import TiledSR, pad_to_multiple, whole_frame_sr
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.io import geotiff, netcdf
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.ops.pack12 import MAX_ABS_ERR, pack12, packed_len, unpack12

torch.set_num_threads(1)

CPU = torch.device("cpu")


# --------------------------------------------------------------------------- pack12
def test_pack12_words_equal_jax_bit_for_bit(rng):
    x = rng.uniform(-1.7, 1.7, size=(3, 1001)).astype(np.float32)
    x[0, :5] = [-1.5, 1.5, 0.0, -2.0, 2.0]  # the range's ends and clamped values
    want = np.asarray(jax_pack12(jnp.asarray(x)))
    got = pack12(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (3, packed_len(1001))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_unpack12_roundtrip_within_max_abs_err(rng):
    x = rng.uniform(-1.5, 1.5, size=(2, 77)).astype(np.float32)
    back = unpack12(pack12(torch.from_numpy(x)).numpy(), 77)
    assert back.shape == (2, 77)
    assert np.abs(back - x).max() <= MAX_ABS_ERR + 1e-7


# --------------------------------------------------------------------------- small ESRGAN pair
@pytest.fixture(scope="module")
def esrgan_pair():
    """A small JAX ESRGAN (f32) and the port's with the same weights."""
    m = jax_create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, use_pallas=False)
    params = m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 1))
    )["params"]
    port = create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, device="cpu")
    port.load_state_dict(state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return m, params, port


def _jax_fn(m, params):
    return lambda lr, elev, mask: m.apply({"params": params}, lr, elev, mask)


@pytest.mark.parametrize("h,w", [(40, 56), (37, 53)], ids=["grid-exact", "reflect-padded"])
def test_tiled_sr_matches_jax(rng, esrgan_pair, h, w):
    """Grouped blend (24 tiles), static LR channels, balanced chunks (72 tiles
    in calls of 9), land gather, f16 and pack12 readbacks."""
    m, params, port = esrgan_pair
    s, k = 4, 3
    frames = rng.uniform(-1, 1, size=(k, h, w, 1)).astype(np.float32)
    static = rng.uniform(-1, 1, size=(h, w, 2)).astype(np.float32)
    elev = rng.uniform(-1, 1, size=(h * s, w * s, 1)).astype(np.float32)
    mask = (rng.random((h * s, w * s, 1)) > 0.6).astype(np.float32)
    land = np.flatnonzero(mask.ravel())
    geometry = dict(scale=s, tile_size=16, overlap=4, batch_size=10)
    for use_pack12 in (False, True):
        jt = JaxTiledSR(_jax_fn(m, params), compute_dtype=jnp.float32, output_dtype=jnp.float16,
                        pack_indices=land, pack12=use_pack12, **geometry)
        pt = TiledSR(make_generator_fn(port, "esrgan"), compute_dtype=torch.float32,
                     output_dtype=torch.float16, pack_indices=land, pack12=use_pack12, device=CPU, **geometry)
        for t in (jt, pt):
            t.set_extras((elev, mask))
            t.set_static_lr_channels(static)
        want = np.asarray(jt.device_call_many(frames))
        got = pt.device_call_many(frames).numpy()
        assert got.shape == want.shape
        if use_pack12:
            got, want = unpack12(got, land.size), unpack12(want.view(np.int32), land.size)
            tol = MAX_ABS_ERR * 2 + 1e-4  # one code step where the f32 sums round apart
        else:
            got, want = got.astype(np.float32), want.astype(np.float32)
            tol = 2e-3  # one f16 ulp at |x| < 2
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_tiled_sr_full_frame_and_post_fn_match_jax(rng, esrgan_pair):
    """Unpacked frames with a device-side denormalizing post_fn, per-frame args."""
    m, params, port = esrgan_pair
    frames = rng.uniform(-1, 1, size=(2, 30, 45, 3)).astype(np.float32)
    elev = rng.uniform(-1, 1, size=(120, 180, 1)).astype(np.float32)
    mask = np.ones((120, 180, 1), np.float32)
    post_args = np.array([[0.0, 10.0], [-5.0, 5.0]], np.float32)
    geometry = dict(scale=4, tile_size=16, overlap=2, batch_size=64)
    jt = JaxTiledSR(_jax_fn(m, params), compute_dtype=jnp.float32,
                    post_fn=lambda o, a: (o + 1) / 2 * (a[1] - a[0]) + a[0], **geometry)
    pt = TiledSR(make_generator_fn(port, "esrgan"), compute_dtype=torch.float32, device=CPU,
                 post_fn=lambda o, a: (o + 1) / 2 * (a[1] - a[0]) + a[0], **geometry)
    want = np.asarray(jt.device_call_many(frames, extras=(elev, mask), post_args=post_args))
    got = pt.device_call_many(frames, extras=(elev, mask), post_args=post_args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_tiled_sr_exact_for_nearest_generator(rng):
    """With a nearest-upsample 'generator' the blended frame is exactly the
    upsampled input (weights sum to 1 everywhere), as in the JAX tests."""

    def fn(lr, *_):
        return lr[..., :1].repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)

    frame = rng.normal(size=(90, 113, 1)).astype(np.float32)
    out = TiledSR(fn, scale=4, tile_size=32, overlap=8, batch_size=4, compute_dtype=torch.float32, device=CPU)(frame)
    np.testing.assert_allclose(out, np.repeat(np.repeat(frame, 4, 0), 4, 1), atol=1e-5)
    padded, hw = pad_to_multiple(frame, 32)
    assert padded.shape == (96, 128, 1) and hw == (90, 113)
    whole = whole_frame_sr(fn, frame[None], batch_size=1, compute_dtype=torch.float32, device=CPU)
    np.testing.assert_allclose(whole[0], np.repeat(np.repeat(frame, 4, 0), 4, 1), atol=1e-6)


# --------------------------------------------------------------------------- guards
def test_tiled_sr_refuses_pack12_with_post_fn():
    with pytest.raises(ValueError, match="post_fn"):
        TiledSR(lambda *a: a[0], scale=4, tile_size=16, overlap=4, pack_indices=np.arange(4),
                pack12=True, post_fn=lambda o, a: o, device=CPU)
    with pytest.raises(ValueError, match="pack_indices"):
        TiledSR(lambda *a: a[0], scale=4, tile_size=16, overlap=4, pack12=True, device=CPU)


# --------------------------------------------------------------------------- files
def _write_world(root, rng, h=40, w=80, months=3, hr_shape=None, scale=4):
    """NetCDF months + elevation/land-mask GeoTIFFs (the JAX package's writers)."""
    hr_h, hr_w = hr_shape or (h * scale, w * scale)
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, : h // 8, :] = np.nan
    time = np.array([f"1901-{m:02d}-16" for m in range(1, months + 1)], dtype="datetime64[D]")
    nc = root / "cru_ts4.05.1901.2020.tmp.dat.nc"
    jax_netcdf.write_climate_series(
        nc, jax_netcdf.ClimateSeries("tmp", data, time, np.linspace(-89, 89, h), np.linspace(-179, 179, w))
    )
    mask = np.where(rng.random((hr_h, hr_w)) > 0.5, 1.0, np.nan).astype(np.float32)
    mask[: hr_h // 8, :] = np.nan
    jax_geotiff.write_geotiff(root / "land_mask.tif", mask, jax_geotiff.GeoProfile.global_grid(hr_h, hr_w))
    elev = rng.normal(500, 300, size=(hr_h, hr_w)).astype(np.float32)
    elev[hr_h // 2, hr_w // 2] = jconsts.world_clim.elevation_missing_indicator
    jax_geotiff.write_geotiff(root / "elevation.tif", elev, jax_geotiff.GeoProfile.global_grid(hr_h, hr_w, nodata=None))
    return dict(nc=str(nc), elevation_file=str(root / "elevation.tif"), land_mask_file=str(root / "land_mask.tif"))


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], str):
            assert a[key] == b[key]
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize(
    "generator_type,hr_shape",
    [("esrgan", None), ("esrgan", (170, 330)), ("srcnn", None)],
    ids=["esrgan-ratio-4", "esrgan-ratio-non-integer", "srcnn-ratio-4"],
)
def test_cruts_dataset_matches_jax(tmp_path, rng, hr_shape, generator_type):
    """cv2's INTER_NEAREST (JAX package) against the port's numpy resize. (The
    srcnn input is the LR frame upscaled to HR, so its rasters share the x4 grid.)"""
    f = _write_world(tmp_path, rng, h=24, w=48, hr_shape=hr_shape)
    kwargs = dict(elevation_file=f["elevation_file"], land_mask_file=f["land_mask_file"],
                  generator_type=generator_type, scaling_factor=4)
    a = jax_datasets.CRUTSInferenceDataset(ds_path=f["nc"], **kwargs)
    b = datasets.CRUTSInferenceDataset(ds_path=f["nc"], **kwargs)
    assert len(a) == len(b) == 3
    np.testing.assert_array_equal(a.elevation_lr, b.elevation_lr)
    np.testing.assert_array_equal(a.mask_lr, b.mask_lr)
    for i in range(3):
        _assert_items_equal(a[i], b[i])


@pytest.mark.parametrize("hr_size", [452, 450], ids=["ratio-4", "ratio-non-integer"])
@pytest.mark.parametrize("generator_type", ["esrgan", "srcnn"])
def test_geotiff_dataset_matches_jax(tmp_path, rng, hr_size, generator_type):
    import pandas as pd

    lr = hr_size // 4
    f = _write_world(tmp_path, rng, hr_shape=(hr_size, hr_size))
    tiff_dir = tmp_path / "tmp"
    rows = []
    for i in range(2):
        name = f"tmp_2001-0{i + 1}.tif"
        jax_geotiff.write_geotiff(tiff_dir / name, rng.normal(10, 3, size=(lr, lr)).astype(np.float32))
        rows.append({"filename": name, "min": 1.0, "max": 20.0, "global_min": -3.0, "global_max": 25.0})
    kwargs = dict(tiff_dir=str(tiff_dir), tiff_df=pd.DataFrame(rows), elevation_file=f["elevation_file"],
                  land_mask_file=f["land_mask_file"], generator_type=generator_type, variable="tmp",
                  hr_size=hr_size)
    a = jax_datasets.GeoTiffInferenceDataset(**kwargs)
    b = datasets.GeoTiffInferenceDataset(**kwargs)
    np.testing.assert_array_equal(a.elevation_lr, b.elevation_lr)
    for i in range(2):
        _assert_items_equal(a[i], b[i])


def test_geotiff_and_netcdf_cross_read(tmp_path, rng):
    """The port writes and the JAX package reads, and the other way round."""
    arr = rng.normal(size=(13, 21)).astype(np.float32)
    arr[0, 0] = np.nan
    prof = geotiff.GeoProfile(width=21, height=13, origin_x=-16.0, origin_y=84.5, pixel_size_x=0.25,
                              pixel_size_y=0.5, nodata=np.nan)
    geotiff.write_geotiff(tmp_path / "p.tif", arr, prof)
    jax_geotiff.write_geotiff(tmp_path / "j.tif", arr, jax_geotiff.GeoProfile(**vars(prof)))
    for reader, path in ((jax_geotiff.read_geotiff, "p.tif"), (geotiff.read_geotiff, "j.tif")):
        back, p = reader(tmp_path / path)
        np.testing.assert_array_equal(back, arr)
        assert (p.origin_x, p.origin_y, p.pixel_size_x, p.pixel_size_y) == (-16.0, 84.5, 0.25, 0.5)
        assert np.isnan(p.nodata)
    np.testing.assert_array_equal(geotiff.read_raster(tmp_path / "j.tif"), arr)

    data = rng.normal(size=(2, 5, 7)).astype(np.float32)
    data[1, 2, 3] = np.nan
    time = np.array(["1901-01-16", "1901-02-16"], dtype="datetime64[D]")
    lat, lon = np.linspace(-10, 10, 5), np.linspace(0, 30, 7)
    netcdf.write_climate_series(tmp_path / "p.nc", netcdf.ClimateSeries("tmp", data, time, lat, lon))
    jax_netcdf.write_climate_series(tmp_path / "j.nc", jax_netcdf.ClimateSeries("tmp", data, time, lat, lon))
    for reader, path in ((jax_netcdf.read_climate_series, "p.nc"), (netcdf.read_climate_series, "j.nc")):
        s = reader(tmp_path / path, "tmp")
        np.testing.assert_array_equal(s.data, data)
        np.testing.assert_array_equal(s.time, time)
        np.testing.assert_array_equal(s.lat, lat)


def test_geotiff_reader_raises_on_layouts_it_cannot_read(tmp_path):
    arr = np.zeros((4, 4), np.float32)
    geotiff.write_geotiff(tmp_path / "a.tif", arr)
    buf = bytearray((tmp_path / "a.tif").read_bytes())
    # SamplesPerPixel (tag 277) -> 3: a layout the codec does not read
    n = int.from_bytes(buf[8:10], "little")
    for i in range(n):
        off = 10 + 12 * i
        if int.from_bytes(buf[off : off + 2], "little") == 277:
            buf[off + 8 : off + 10] = (3).to_bytes(2, "little")
    (tmp_path / "b.tif").write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="samples per pixel"):
        geotiff.read_geotiff(tmp_path / "b.tif")


# --------------------------------------------------------------------------- end to end
def _tifs(paths):
    return [geotiff.read_geotiff(p)[0] for p in paths]


@pytest.mark.parametrize("tile_size", [16, None], ids=["tiled-16-4", "whole-frame"])
def test_inference_on_full_images_matches_jax(tmp_path, rng, esrgan_pair, tile_size):
    """A tiny globe (40x80 LR, 3 months) end to end: the same GeoTIFFs as the
    JAX package's sweep, within the 12-bit readback step (tiled) or the f32
    sums (whole frame), and the NetCDF export reads back in the JAX reader."""
    m, params, port = esrgan_pair
    f = _write_world(tmp_path, rng)
    ds_kwargs = dict(ds_path=f["nc"], elevation_file=f["elevation_file"], land_mask_file=f["land_mask_file"],
                     generator_type="esrgan", scaling_factor=4)
    run = dict(generator_type="esrgan", batch_size=2, tile_size=tile_size, tile_overlap=4)
    want = jax_inference_on_full_images(m, params, jax_datasets.CRUTSInferenceDataset(**ds_kwargs),
                                        str(tmp_path / "jax" / "tmp"), **run)
    ds = datasets.CRUTSInferenceDataset(**ds_kwargs)
    got = inference_on_full_images(port, ds, str(tmp_path / "port" / "tmp"), device="cpu", **run)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for i, (a, b) in enumerate(zip(_tifs(got), _tifs(want))):
        assert a.shape == (160, 320)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        half_range = (float(ds[i]["max"]) - float(ds[i]["min"])) / 2
        step = 2 * MAX_ABS_ERR if tile_size else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=(step + 1e-4) * half_range)

    transform_tiff_files_to_net_cdf(str(tmp_path / "port"), str(tmp_path / "nc"), ["tmp"], prefix="esrgan")
    (nc,) = list((tmp_path / "nc").glob("*.nc"))
    assert nc.name == "esrgan.cru_ts4.05.nn.inference.1901.2020.tmp.dat.nc"
    back = jax_netcdf.read_climate_series(nc, "tmp")
    assert back.data.shape == (3, 160, 320)
    np.testing.assert_array_equal(back.data[0], _tifs(got)[0][::-1])


def test_tiled_sweeps_gap_to_the_whole_frame_is_the_jax_packages(tmp_path, rng, esrgan_pair):
    """The tiled sweep is no stand-in for the whole frame: its tiles see
    ``overlap`` pixels of context and the frame is reflect-padded to the tile
    grid where the whole frame zero-pads. That gap is the JAX package's own:
    the port's tiled-minus-whole GeoTIFFs equal the JAX package's within two
    12-bit steps, and the gap is over 10x that."""
    m, params, port = esrgan_pair
    f = _write_world(tmp_path, rng)
    ds_kwargs = dict(ds_path=f["nc"], elevation_file=f["elevation_file"], land_mask_file=f["land_mask_file"],
                     generator_type="esrgan", scaling_factor=4)
    gaps = {}
    for pkg in ("jax", "port"):
        runs = {}
        for tile_size in (16, None):
            out = str(tmp_path / f"{pkg}{tile_size}" / "tmp")
            run = dict(generator_type="esrgan", batch_size=2, tile_size=tile_size, tile_overlap=4)
            if pkg == "jax":
                paths = jax_inference_on_full_images(m, params, jax_datasets.CRUTSInferenceDataset(**ds_kwargs), out,
                                                     **run)
            else:
                paths = inference_on_full_images(port, datasets.CRUTSInferenceDataset(**ds_kwargs), out, device="cpu",
                                                 **run)
            runs[tile_size] = np.stack(_tifs(paths))
        gaps[pkg] = runs[16] - runs[None]
    ds = datasets.CRUTSInferenceDataset(**ds_kwargs)
    half = np.array([(float(ds[i]["max"]) - float(ds[i]["min"])) / 2 for i in range(len(ds))])[:, None, None]
    tol = 2 * MAX_ABS_ERR + 2e-4
    np.testing.assert_allclose(gaps["port"] / half, gaps["jax"] / half, rtol=0, atol=tol)
    assert np.nanmax(np.abs(gaps["jax"]) / half) > 10 * tol


def test_readback_outside_the_two_encodings_raises(tmp_path, rng, esrgan_pair):
    f = _write_world(tmp_path, rng, months=1)
    ds = datasets.CRUTSInferenceDataset(ds_path=f["nc"], elevation_file=f["elevation_file"],
                                        land_mask_file=f["land_mask_file"], generator_type="esrgan")
    with pytest.raises(ValueError, match="readback"):
        inference_on_full_images(esrgan_pair[2], ds, str(tmp_path / "o"), "esrgan", readback="u8", device="cpu")


def test_pack12_is_not_used_under_standard_scaler(tmp_path, rng, caplog):
    """z-scores beyond +-1.5 would be clamped by pack12: under a StandardScaler
    the tiled sweep reads back f16, and values of |z| up to 3 survive."""
    import pandas as pd

    class Triple(torch.nn.Module):
        """A 'generator' whose output is 3x the nearest-upsampled input."""

        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.tensor(3.0))

        def forward(self, x, elev, mask):
            return self.scale * x[:, :1].repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)

    f = _write_world(tmp_path, rng, months=1)
    stats = pd.DataFrame([{"variable": "tmp", "mean": 10.0, "std": 5.0},
                          {"variable": "elevation", "mean": 500.0, "std": 300.0}])
    ds = datasets.CRUTSInferenceDataset(ds_path=f["nc"], elevation_file=f["elevation_file"],
                                        land_mask_file=f["land_mask_file"], generator_type="esrgan",
                                        normalize=False, standardize=True, standardize_stats=stats)
    assert isinstance(ds.scaler, StandardScaler)
    with caplog.at_level(logging.WARNING, logger="climsr_tpu_torch.inference.run"):
        (path,) = inference_on_full_images(Triple(), ds, str(tmp_path / "o" / "tmp"), "esrgan",
                                           tile_size=16, tile_overlap=4, readback="pack12", device="cpu")
    assert "f16" in caplog.text
    out = geotiff.read_geotiff(path)[0]
    # the tiler uploads bf16; the f16 readback then costs at most 2.5e-3 of |3z| <= 12
    z = torch.from_numpy(np.asarray(ds[0]["lr"])[..., 0]).to(torch.bfloat16).float().numpy()
    want = np.repeat(np.repeat(3 * z, 4, 0), 4, 1) * 5.0 + 10.0
    land = ~np.isnan(out)
    assert np.abs(3 * z).max() > 3  # the case pack12 would clamp
    np.testing.assert_allclose(out[land], want[land], rtol=0, atol=0.05)


# --------------------------------------------------------------------------- normalization
def test_scalers_on_torch_tensors_match_numpy_and_jax(rng):
    """The scalers' torch namespace gives the numpy results (which equal the
    JAX package's on the same arrays), per-sample stats broadcast included."""
    from climsr_tpu.data import normalization as jax_norm
    from climsr_tpu_torch.data.normalization import MinMaxScaler

    arr = rng.normal(10, 5, size=(3, 6, 7, 1)).astype(np.float32)
    arr[0, 0, 0, 0] = np.nan
    arr[1, 2, 3, 0] = -32768.0
    mm = MinMaxScaler(feature_range=(-1.0, 1.0))
    want = jax_norm.MinMaxScaler(feature_range=(-1.0, 1.0)).normalize(arr, missing_indicator=-32768.0)
    np.testing.assert_array_equal(mm.normalize(arr, missing_indicator=-32768.0), want)
    got = mm.normalize(torch.from_numpy(arr), missing_indicator=-32768.0)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    vmin, vmax = np.array([0.0, -3.0, 1.0], np.float32), np.array([20.0, 25.0, 9.0], np.float32)
    x = rng.uniform(-1, 1, size=(3, 6, 7, 1)).astype(np.float32)
    want = jax_norm.MinMaxScaler(feature_range=(-1.0, 1.0)).denormalize(x, vmin, vmax)
    np.testing.assert_allclose(mm.denormalize(torch.from_numpy(x), vmin, vmax).numpy(), want, rtol=1e-6)
    z = StandardScaler(mean=10.0, std=5.0)
    want = jax_norm.StandardScaler(mean=10.0, std=5.0).normalize(arr, missing_indicator=-32768.0)
    np.testing.assert_allclose(z.normalize(torch.from_numpy(arr), missing_indicator=-32768.0).numpy(), want,
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(z.denormalize(torch.from_numpy(x)).numpy(), x * 5.0 + 10.0, rtol=1e-6)


# --------------------------------------------------------------------------- run_inference
def _lookups(tmp_path, var="tmp"):
    import pandas as pd

    min_max = tmp_path / "min_max.feather"
    pd.DataFrame([
        {"dataset": "cru-ts", "variable": var, "filename": f"{var}_2001-01.tif", "min": 1.0, "max": 20.0,
         "global_min": -3.0, "global_max": 25.0},
        {"dataset": "world-clim", "variable": var, "filename": f"{var}_2001-01.tif", "min": 0.0, "max": 1.0,
         "global_min": 0.0, "global_max": 1.0},
    ]).to_feather(min_max)
    zscore = tmp_path / "zscore.feather"
    pd.DataFrame([{"variable": var, "mean": 10.0, "std": 5.0}]).to_feather(zscore)
    return str(min_max), str(zscore)


@pytest.mark.parametrize("use_netcdf", [True, False], ids=["netcdf", "geotiff"])
def test_run_inference_matches_jax(tmp_path, rng, esrgan_pair, use_netcdf):
    """``run_inference`` from a reference-style PL ``.ckpt`` (bf16 weights, as
    both packages load them) against the JAX package's, on the NetCDF and the
    GeoTIFF dataset. Tolerance: 2e-2 of each month's range — both sides run
    the generator in bf16 and round its intermediates at different places."""
    from types import SimpleNamespace

    from climsr_tpu.config.schemas import InferenceConfig
    from climsr_tpu.inference.run import run_inference as jax_run_inference
    from climsr_tpu_torch.inference.run import run_inference

    _, _, port = esrgan_pair
    ckpt = tmp_path / "esrgan.ckpt"
    torch.save({"state_dict": {f"generator.{k}": v for k, v in port.state_dict().items()}}, ckpt)
    if use_netcdf:
        f = _write_world(tmp_path, rng, h=24, w=48, months=2)
        ds = dict(ds_path=f["nc"], tiff_dir=str(tmp_path))
    else:
        f = _write_world(tmp_path, rng, months=1, hr_shape=(452, 452))
        jax_geotiff.write_geotiff(tmp_path / "tiffs" / "tmp" / "tmp_2001-01.tif",
                                  rng.normal(10, 3, size=(113, 113)).astype(np.float32))
        ds = dict(ds_path=f["nc"], tiff_dir=str(tmp_path / "tiffs"))
    min_max, zscore = _lookups(tmp_path)
    fields = dict(
        generator_type="esrgan", use_netcdf_datasets=use_netcdf, elevation_file=f["elevation_file"],
        land_mask_file=f["land_mask_file"], min_max_lookup=min_max, zscore_lookup=zscore,
        pretrained_model=str(ckpt), batch_size=2, tile_size=16, tile_overlap=4, **ds,
    )
    gen_kwargs = dict(nf=8, nb=1, gc=8, out_channels=1)
    jax_run_inference(InferenceConfig(inference_out_path=str(tmp_path / "jax"), **fields), ["tmp"], gen_kwargs)
    cfg = SimpleNamespace(**{**vars(InferenceConfig(**fields)), "inference_out_path": str(tmp_path / "port")})
    run_inference(cfg, ["tmp"], gen_kwargs, device="cpu")
    want = sorted((tmp_path / "jax" / "tmp").glob("*.tif"))
    got = sorted((tmp_path / "port" / "tmp").glob("*.tif"))
    assert [p.name for p in got] == [p.name for p in want] and got
    for a, b in zip(_tifs(got), _tifs(want)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        land = ~np.isnan(b)
        span = np.nanmax(b) - np.nanmin(b)
        np.testing.assert_allclose(a[land], b[land], rtol=0, atol=2e-2 * span)


# --------------------------------------------------------------------------- chip_smoke.py
def test_chip_smoke_phases_run_on_cpu_at_small_size():
    """chip_smoke.py's generator and whole-globe phases, with the plain RDB on
    the CPU at a tiny width (the card runs them at full width), and its bound
    at the main path's shape: 65.2 GFLOP at 989 TFLOP/s."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_generator(CPU, nf=16, nb=1, gc=16, n=2, lr=8)
    out = smoke.phase_globe(CPU, months=2, h=36, w=72, nf=16, nb=1, gc=16, dtype=torch.float32,
                            tile_size=16, tile_overlap=4)
    assert out["months"] == 2 and out["launches"] == 0  # the CPU never launches the kernel
    x = torch.empty(16, 64, 128, 128, dtype=torch.bfloat16, device="meta")
    bound, by = smoke.rdb_bound_ms(x, with_x0=False)
    assert by == "operations" and abs(bound - 65.2e9 / 989e12 * 1e3) < 1e-3
