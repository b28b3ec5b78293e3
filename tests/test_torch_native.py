# -*- coding: utf-8 -*-
"""The port's native raster IO (``climsr_tpu_torch/native``, its own build of
``tiffio.cpp``) against the JAX package's ``tiffio.cpp``, its Python codec and
cv2.

The JAX package's source is compiled here once per module, with the port's
flags, and called with the arguments the JAX wrappers pass, so the reference
does not hang on whether the JAX package's loader built its library in this
process.

- single reads (f32 with NaN, u8, i16 with predictor 2) equal the JAX
  library's, the JAX codec's and the written arrays, bitwise;
- files the native decoder declines (predictor 3, tiled, not a TIFF) give
  None in both, and ``read_raster`` reads them through the Python codec with
  the JAX codec's result, counted in ``READS``;
- the threaded batch decode equals the JAX one, statuses included;
- the nearest resize equals the JAX library's and ``cv2.INTER_NEAREST`` at
  the JAX test's factors and at the preprocessing's 1/3, 2/3 and 4/3
  (full-width rows and full-height columns of the 2880 x 1440 target).
"""
import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from climsr_tpu import native as jax_native
from climsr_tpu.io.geotiff import read_geotiff as jax_read_geotiff
from climsr_tpu.io.geotiff import write_geotiff as jax_write_geotiff
from climsr_tpu_torch import native
from climsr_tpu_torch.io import geotiff
from climsr_tpu_torch.io.geotiff import GeoProfile, read_geotiff, read_raster, write_geotiff
from test_io import _write_tiff_f32_pred3, _write_tiff_i16_pred2

torch.set_num_threads(1)

JAX_SRC = Path(jax_native.__file__).with_name("tiffio.cpp")
F32P, I32P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory) -> ctypes.CDLL:
    """The JAX package's ``tiffio.cpp`` built into a temporary file, moved in
    place and bound with the port's signatures; the port's library loaded."""
    assert native.native_available(), native.native_error()
    out = tmp_path_factory.mktemp("jax_tiffio")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
    os.close(fd)
    cmd = ["g++", *native.GXX_FLAGS, str(JAX_SRC), "-o", tmp, *native.LINK_FLAGS]
    built = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr
    path = out / "libclimsr_io_jax.so"
    os.replace(tmp, path)
    return native._bind(ctypes.CDLL(str(path)))


def _jax_read(lib, path):
    """``climsr_tpu.native.read_raster_native``'s calls."""
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.climsr_tiff_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.climsr_tiff_read_f32(str(path).encode(), out.ctypes.data_as(F32P), h.value, w.value)
    return out if rc == 0 else None


def _jax_read_batch(lib, paths, h, w, n_threads):
    """``climsr_tpu.native.read_tiles_batch_native``'s call."""
    out = np.empty((len(paths), h, w), np.float32)
    status = np.empty((len(paths),), np.int32)
    names = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    lib.climsr_tiff_read_batch_f32(names, len(paths), out.ctypes.data_as(F32P), h, w, n_threads,
                                   status.ctypes.data_as(I32P))
    return out, status


def _jax_resize(lib, src, dh, dw):
    """``climsr_tpu.native.nearest_resize_native``'s call."""
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty((dh, dw), np.float32)
    lib.climsr_nearest_resize_f32(src.ctypes.data_as(F32P), src.shape[0], src.shape[1], dst.ctypes.data_as(F32P),
                                  dh, dw)
    return dst


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


def test_reads_match_the_jax_library(jax_lib, tmp_path, rng):
    for name, arr in _files(tmp_path, rng).items():
        got = native.read_raster_native(tmp_path / name)
        want = _jax_read(jax_lib, tmp_path / name)
        codec = jax_read_geotiff(tmp_path / name)[0].astype(np.float32)
        assert got is not None and got.dtype == np.float32
        assert got.tobytes() == want.tobytes() == codec.tobytes() == arr.astype(np.float32).tobytes(), name


def test_declined_files_go_to_the_python_codec(jax_lib, tmp_path, rng):
    f32 = rng.normal(size=(20, 24)).astype(np.float32)
    i16 = rng.integers(-3000, 6000, size=(24, 32)).astype(np.int16)
    _write_tiff_f32_pred3(tmp_path / "p3.tif", f32, tile=0)
    _write_tiff_i16_pred2(tmp_path / "tiled.tif", i16, tile=16)
    (tmp_path / "garbage.tif").write_bytes(b"garbage data here")
    for name in ("p3.tif", "tiled.tif", "garbage.tif"):
        assert native.read_raster_native(tmp_path / name) is None
        assert _jax_read(jax_lib, tmp_path / name) is None
    geotiff.READS.reset()
    for name, arr in (("p3.tif", f32), ("tiled.tif", i16)):
        got = read_raster(tmp_path / name)
        np.testing.assert_array_equal(got, arr)
        assert got.tobytes() == jax_read_geotiff(tmp_path / name)[0].tobytes(), name
    assert (geotiff.READS.native, geotiff.READS.python) == (0, 2)
    write_geotiff(tmp_path / "ok.tif", f32)
    np.testing.assert_array_equal(read_raster(tmp_path / "ok.tif"), read_geotiff(tmp_path / "ok.tif")[0])
    assert (geotiff.READS.native, geotiff.READS.python) == (1, 2)
    with pytest.raises(ValueError):
        read_raster(tmp_path / "garbage.tif")
    with pytest.raises(ValueError):
        jax_read_geotiff(tmp_path / "garbage.tif")


def test_batch_decode_matches_the_jax_library(jax_lib, tmp_path, rng):
    paths, arrays = [], []
    for i in range(10):
        arr = rng.normal(size=(32, 32)).astype(np.float32)
        write_geotiff(tmp_path / f"tile{i}.tif", arr)
        paths.append(str(tmp_path / f"tile{i}.tif"))
        arrays.append(arr)
    write_geotiff(tmp_path / "small.tif", arrays[0][:16])
    paths += [str(tmp_path / "missing.tif"), str(tmp_path / "small.tif")]
    tiles, status = native.read_tiles_batch_native(paths, 32, 32, n_threads=4)
    want_tiles, want_status = _jax_read_batch(jax_lib, paths, 32, 32, n_threads=4)
    np.testing.assert_array_equal(status, want_status)
    assert (status[:10] == 0).all() and (status[10:] != 0).all()
    np.testing.assert_array_equal(tiles[:10], np.stack(arrays))
    assert tiles[:10].tobytes() == want_tiles[:10].tobytes()
    assert tiles[:10].tobytes() == np.stack([jax_read_geotiff(p)[0] for p in paths[:10]]).tobytes()


@pytest.mark.parametrize("src, dst", [
    ((128, 128), (32, 32)), ((128, 128), (256, 256)),  # the JAX test's factors
    ((3, 8640), (3, 2880)), ((4320, 2), (1440, 2)),  # 2.5m -> the target: 1/3
    ((3, 4320), (3, 2880)), ((2160, 2), (1440, 2)),  # 5m: 2/3
    ((3, 2160), (3, 2880)), ((1080, 2), (1440, 2)),  # 10m: 4/3
    ((270, 540), (360, 720)), ((97, 61), (40, 150)),
])
def test_nearest_resize_matches_cv2(jax_lib, src, dst):
    import cv2

    img = np.random.default_rng(0).normal(size=src).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = native.nearest_resize_native(img, *dst)
    assert got.shape == dst and got.tobytes() == want.tobytes()
    assert got.tobytes() == _jax_resize(jax_lib, img, *dst).tobytes()
