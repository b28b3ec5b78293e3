# -*- coding: utf-8 -*-
"""The port's native raster IO (``climsr_tpu_torch/native``, its own build of
``tiffio.cpp``) against the JAX package's library and against cv2.

- single reads (f32 with NaN, u8, i16 with predictor 2) equal the JAX
  library's and the written arrays, bitwise;
- files the native decoder declines (predictor 3, tiled, not a TIFF) give
  None in both, and ``read_raster`` reads them through the Python codec with
  the same result, counted in ``READS``;
- the threaded batch decode equals the JAX one, statuses included;
- the nearest resize equals ``cv2.INTER_NEAREST`` at the JAX test's factors
  and at the preprocessing's 1/3, 2/3 and 4/3 (full-width rows and
  full-height columns of the 2880 x 1440 target).
"""
import numpy as np
import pytest
import torch

from climsr_tpu import native as jax_native
from climsr_tpu.io.geotiff import write_geotiff as jax_write_geotiff
from climsr_tpu_torch import native
from climsr_tpu_torch.io import geotiff
from climsr_tpu_torch.io.geotiff import GeoProfile, read_geotiff, read_raster, write_geotiff
from test_io import _write_tiff_f32_pred3, _write_tiff_i16_pred2

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert native.native_available(), native.native_error()
    assert jax_native.native_available()


def _files(tmp_path, rng) -> dict:
    f32 = rng.normal(size=(64, 48)).astype(np.float32)
    f32[0, 0] = np.nan
    u8 = rng.integers(0, 255, size=(16, 16)).astype(np.uint8)
    i16 = rng.integers(-3000, 6000, size=(24, 32)).astype(np.int16)
    write_geotiff(tmp_path / "f32.tif", f32, GeoProfile.global_grid(64, 48))
    jax_write_geotiff(tmp_path / "f32_jax.tif", f32)
    write_geotiff(tmp_path / "u8.tif", u8, GeoProfile(width=16, height=16, nodata=None))
    _write_tiff_i16_pred2(tmp_path / "i16p2.tif", i16, tile=0)
    return {"f32.tif": f32, "f32_jax.tif": f32, "u8.tif": u8, "i16p2.tif": i16}


def test_reads_match_the_jax_library(tmp_path, rng):
    for name, arr in _files(tmp_path, rng).items():
        got = native.read_raster_native(tmp_path / name)
        want = jax_native.read_raster_native(tmp_path / name)
        assert got is not None and got.dtype == np.float32
        assert got.tobytes() == want.tobytes() == arr.astype(np.float32).tobytes(), name


def test_declined_files_go_to_the_python_codec(tmp_path, rng):
    f32 = rng.normal(size=(20, 24)).astype(np.float32)
    i16 = rng.integers(-3000, 6000, size=(24, 32)).astype(np.int16)
    _write_tiff_f32_pred3(tmp_path / "p3.tif", f32, tile=0)
    _write_tiff_i16_pred2(tmp_path / "tiled.tif", i16, tile=16)
    (tmp_path / "garbage.tif").write_bytes(b"garbage data here")
    for name in ("p3.tif", "tiled.tif", "garbage.tif"):
        assert native.read_raster_native(tmp_path / name) is None
        assert jax_native.read_raster_native(tmp_path / name) is None
    geotiff.READS.reset()
    np.testing.assert_array_equal(read_raster(tmp_path / "p3.tif"), f32)
    np.testing.assert_array_equal(read_raster(tmp_path / "tiled.tif"), i16)
    assert (geotiff.READS.native, geotiff.READS.python) == (0, 2)
    write_geotiff(tmp_path / "ok.tif", f32)
    np.testing.assert_array_equal(read_raster(tmp_path / "ok.tif"), read_geotiff(tmp_path / "ok.tif")[0])
    assert (geotiff.READS.native, geotiff.READS.python) == (1, 2)
    with pytest.raises(ValueError):
        read_raster(tmp_path / "garbage.tif")


def test_batch_decode_matches_the_jax_library(tmp_path, rng):
    paths, arrays = [], []
    for i in range(10):
        arr = rng.normal(size=(32, 32)).astype(np.float32)
        write_geotiff(tmp_path / f"tile{i}.tif", arr)
        paths.append(str(tmp_path / f"tile{i}.tif"))
        arrays.append(arr)
    write_geotiff(tmp_path / "small.tif", arrays[0][:16])
    paths += [str(tmp_path / "missing.tif"), str(tmp_path / "small.tif")]
    tiles, status = native.read_tiles_batch_native(paths, 32, 32, n_threads=4)
    want_tiles, want_status = jax_native.read_tiles_batch_native(paths, 32, 32, n_threads=4)
    np.testing.assert_array_equal(status, want_status)
    assert (status[:10] == 0).all() and (status[10:] != 0).all()
    np.testing.assert_array_equal(tiles[:10], np.stack(arrays))
    np.testing.assert_array_equal(tiles[:10], want_tiles[:10])


@pytest.mark.parametrize("src, dst", [
    ((128, 128), (32, 32)), ((128, 128), (256, 256)),  # the JAX test's factors
    ((3, 8640), (3, 2880)), ((4320, 2), (1440, 2)),  # 2.5m -> the target: 1/3
    ((3, 4320), (3, 2880)), ((2160, 2), (1440, 2)),  # 5m: 2/3
    ((3, 2160), (3, 2880)), ((1080, 2), (1440, 2)),  # 10m: 4/3
    ((270, 540), (360, 720)), ((97, 61), (40, 150)),
])
def test_nearest_resize_matches_cv2(src, dst):
    import cv2

    img = np.random.default_rng(0).normal(size=src).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = native.nearest_resize_native(img, *dst)
    assert got.shape == dst and got.tobytes() == want.tobytes()
