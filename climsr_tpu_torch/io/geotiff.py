# -*- coding: utf-8 -*-
"""Minimal GeoTIFF codec (read + write) with no GDAL/rasterio dependency.

The reference leans on rasterio/GDAL (C) for raster IO
(``climsr/preprocessing/preprocessing.py``, ``climsr/inference/inference.py:81``).
That stack is not available here, so this module implements the subset of
TIFF 6.0 + GeoTIFF 1.1 the pipeline needs:

- **write**: single-band float32/uint8 rasters, strip-organised, uncompressed,
  little-endian, with ``ModelPixelScaleTag``/``ModelTiepointTag`` and a WGS84
  (EPSG:4326) ``GeoKeyDirectoryTag``, plus ``GDAL_NODATA``.
- **read**: strip- or tile-organised, uncompressed / packbits / deflate
  (zlib) / LZW, single-band gray (what CRU-TS/WorldClim exports use). Any
  other layout (several bands, an unlisted sample type) raises ``ValueError``.

A copy of ``climsr_tpu.io.geotiff`` without its native and PIL read paths.

A ``GeoProfile`` mirrors the slice of rasterio's profile dict the reference
passes around (transform origin, pixel scale, nodata, CRS).
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735
_GDAL_NODATA = 42113

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


@dataclasses.dataclass
class GeoProfile:
    """Georeferencing info: top-left origin + pixel size, nodata, EPSG code."""

    width: int
    height: int
    origin_x: float = -180.0
    origin_y: float = 90.0
    pixel_size_x: float = 0.5
    pixel_size_y: float = 0.5  # positive; north-up rasters step -y per row
    nodata: Optional[float] = None
    epsg: int = 4326
    dtype: str = "float32"

    @classmethod
    def global_grid(cls, height: int, width: int, nodata: Optional[float] = np.nan) -> "GeoProfile":
        """Whole-globe lat/lon grid (the CRU-TS / WorldClim layout)."""
        return cls(
            width=width,
            height=height,
            origin_x=-180.0,
            origin_y=90.0,
            pixel_size_x=360.0 / width,
            pixel_size_y=180.0 / height,
            nodata=nodata,
        )


def write_geotiff(path: Union[str, Path], array: np.ndarray, profile: Optional[GeoProfile] = None) -> None:
    """Write a single-band raster as an uncompressed little-endian GeoTIFF."""
    array = np.asarray(array)
    if array.ndim != 2:
        raise ValueError(f"write_geotiff expects a 2D array, got {array.shape}")
    h, w = array.shape
    profile = profile or GeoProfile.global_grid(h, w)

    if array.dtype == np.float64:
        array = array.astype(np.float32)
    if array.dtype == np.float32:
        bits, sample_format = 32, 3
    elif array.dtype == np.uint8:
        bits, sample_format = 8, 1
    elif array.dtype in (np.int16, np.dtype("int16")):
        bits, sample_format = 16, 2
    else:
        array = array.astype(np.float32)
        bits, sample_format = 32, 3

    data = array.tobytes()  # native little-endian on all target platforms

    entries = []  # (tag, type, count, value_bytes or int)

    def add(tag, typ, count, value):
        entries.append([tag, typ, count, value])

    add(_IMAGE_WIDTH, 4, 1, w)
    add(_IMAGE_LENGTH, 4, 1, h)
    add(_BITS_PER_SAMPLE, 3, 1, bits)
    add(_COMPRESSION, 3, 1, 1)
    add(_PHOTOMETRIC, 3, 1, 1)
    add(_STRIP_OFFSETS, 4, 1, None)  # patched later
    add(_SAMPLES_PER_PIXEL, 3, 1, 1)
    add(_ROWS_PER_STRIP, 4, 1, h)
    add(_STRIP_BYTE_COUNTS, 4, 1, len(data))
    add(_PLANAR_CONFIG, 3, 1, 1)
    add(_SAMPLE_FORMAT, 3, 1, sample_format)

    # GeoTIFF tags
    pixel_scale = struct.pack("<3d", profile.pixel_size_x, profile.pixel_size_y, 0.0)
    add(_MODEL_PIXEL_SCALE, 12, 3, pixel_scale)
    tiepoint = struct.pack("<6d", 0.0, 0.0, 0.0, profile.origin_x, profile.origin_y, 0.0)
    add(_MODEL_TIEPOINT, 12, 6, tiepoint)
    # GeoKeyDirectory: version 1.1.0, 3 keys: GTModelType=2 (geographic),
    # GTRasterType=1 (PixelIsArea), GeographicType=epsg
    geokeys = struct.pack(
        "<16H",
        1, 1, 0, 3,
        1024, 0, 1, 2,
        1025, 0, 1, 1,
        2048, 0, 1, profile.epsg,
    )
    add(_GEO_KEY_DIRECTORY, 3, 16, geokeys)
    if profile.nodata is not None:
        nodata_ascii = (f"{profile.nodata:g}" if not np.isnan(profile.nodata) else "nan").encode() + b"\x00"
        add(_GDAL_NODATA, 2, len(nodata_ascii), nodata_ascii)

    entries.sort(key=lambda e: e[0])

    header = struct.pack("<2sHI", b"II", 42, 8)
    ifd_offset = 8
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    blob_offset = ifd_offset + ifd_size

    # lay out oversized values after the IFD
    blobs = b""
    for e in entries:
        tag, typ, count, value = e
        if isinstance(value, (bytes, bytearray)):
            if len(value) <= 4:
                e[3] = value + b"\x00" * (4 - len(value))
            else:
                e[3] = struct.pack("<I", blob_offset + len(blobs))
                blobs += value
        elif value is None:
            pass  # strip offsets patched below
        else:
            fmt = _TYPE_FMT[typ]
            e[3] = struct.pack(f"<{fmt}", value) + b"\x00" * (4 - struct.calcsize(fmt))

    data_offset = blob_offset + len(blobs)
    for e in entries:
        if e[0] == _STRIP_OFFSETS:
            e[3] = struct.pack("<I", data_offset)

    out = bytearray()
    out += header
    out += struct.pack("<H", n)
    for tag, typ, count, value in entries:
        out += struct.pack("<HHI", tag, typ, count) + value
    out += struct.pack("<I", 0)  # next IFD
    out += blobs
    out += data

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)


def _read_ifd(buf: bytes, endian: str, offset: int):
    (n,) = struct.unpack_from(endian + "H", buf, offset)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(endian + "HHI", buf, offset + 2 + i * 12)
        value_field = buf[offset + 10 + i * 12 : offset + 14 + i * 12]
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            raw = value_field[:size]
        else:
            (ptr,) = struct.unpack(endian + "I", value_field)
            raw = buf[ptr : ptr + size]
        if typ in _TYPE_FMT:
            fmt = _TYPE_FMT[typ]
            values = struct.unpack(endian + f"{count}{fmt}", raw)
        elif typ == 2:  # ascii
            values = (raw.rstrip(b"\x00").decode(errors="replace"),)
        else:
            values = (raw,)
        tags[tag] = values
    return tags


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    dictionary = {}

    def reset():
        nonlocal dictionary, next_code, code_bits
        dictionary = {i: bytes([i]) for i in range(256)}
        next_code = 258
        code_bits = 9

    next_code, code_bits = 258, 9
    reset()
    prev = None
    bitbuf, bitcnt = 0, 0
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= code_bits:
            code = (bitbuf >> (bitcnt - code_bits)) & ((1 << code_bits) - 1)
            bitcnt -= code_bits
            if code == CLEAR:
                reset()
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = dictionary[code]
            elif code in dictionary:
                entry = dictionary[code]
                dictionary[next_code] = prev + entry[:1]
                next_code += 1
            else:
                entry = prev + prev[:1]
                dictionary[next_code] = entry
                next_code += 1
            out += entry
            prev = entry
            if next_code + 1 >= (1 << code_bits) and code_bits < 12:
                code_bits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def read_geotiff(path: Union[str, Path]) -> Tuple[np.ndarray, GeoProfile]:
    """Read a single-band GeoTIFF into (array, GeoProfile)."""
    buf = Path(path).read_bytes()
    byte_order = buf[:2]
    if byte_order == b"II":
        endian = "<"
    elif byte_order == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    magic, ifd_offset = struct.unpack_from(endian + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: unsupported TIFF magic {magic}")
    tags = _read_ifd(buf, endian, ifd_offset)

    w = tags[_IMAGE_WIDTH][0]
    h = tags[_IMAGE_LENGTH][0]
    bits = tags.get(_BITS_PER_SAMPLE, (32,))[0]
    compression = tags.get(_COMPRESSION, (1,))[0]
    sample_format = tags.get(_SAMPLE_FORMAT, (1,))[0]
    spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    if spp != 1:
        raise ValueError(f"{path}: {spp} samples per pixel; only single-band rasters are read")

    dtype_map = {(3, 32): "f4", (3, 64): "f8", (1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 16): "i2", (2, 32): "i4"}
    key = (sample_format, bits)
    if key not in dtype_map:
        raise ValueError(f"{path}: unsupported sample format {sample_format} with {bits} bits")
    dtype = np.dtype(endian + dtype_map[key])

    def decode(chunk: bytes) -> bytes:
        if compression == 1:
            return chunk
        if compression in (8, 32946):  # deflate
            return zlib.decompress(chunk)
        if compression == 5:
            return _lzw_decode(chunk)
        if compression == 32773:
            return _packbits_decode(chunk)
        raise ValueError(f"{path}: unsupported TIFF compression {compression}")

    def assemble(raw: bytes, rows: int, cols: int) -> np.ndarray:
        # Predictors reset at the start of each row of each *chunk* (tile or
        # strip), so they must be undone per decoded chunk before assembly — a
        # whole-image cumsum is wrong for tiled files (every pixel right of the
        # first tile column would keep the deltas). Both predictors here are
        # row-wise, so operating on a (rows, ...) view per chunk is exact.
        if predictor == 3:
            # TIFF TechNote 3 floating-point predictor (GDAL emits this for
            # float32 DEFLATE GeoTIFFs): per row, the sample bytes are split
            # into byte planes ordered most-significant first, then
            # byte-differenced horizontally. Undo: modular byte cumsum across
            # the row, then re-interleave planes as big-endian samples.
            s = dtype.itemsize
            b = np.frombuffer(raw, dtype=np.uint8).reshape(rows, s * cols)
            b = np.cumsum(b, axis=1, dtype=np.uint8)  # wraps mod 256 = byte undiff
            planes = b.reshape(rows, s, cols).transpose(0, 2, 1)  # (rows, cols, s) MSB-first
            be = np.dtype(dtype.newbyteorder(">"))
            return np.ascontiguousarray(planes).reshape(rows, s * cols).view(be).astype(dtype)
        chunk = np.frombuffer(raw, dtype=dtype).reshape(rows, cols)
        if predictor == 2:
            return np.cumsum(chunk.astype(np.int64), axis=1).astype(dtype)
        return chunk

    if _TILE_OFFSETS in tags:
        tw = tags[_TILE_WIDTH][0]
        th = tags[_TILE_LENGTH][0]
        offsets = tags[_TILE_OFFSETS]
        counts = tags[_TILE_BYTE_COUNTS]
        tiles_across = (w + tw - 1) // tw
        arr = np.zeros((h, w), dtype=dtype)
        for idx, (off, cnt) in enumerate(zip(offsets, counts)):
            tile = assemble(decode(buf[off : off + cnt]), th, tw)
            ty, tx = divmod(idx, tiles_across)
            y0, x0 = ty * th, tx * tw
            arr[y0 : min(y0 + th, h), x0 : min(x0 + tw, w)] = tile[: min(th, h - y0), : min(tw, w - x0)]
    else:
        offsets = tags[_STRIP_OFFSETS]
        counts = tags[_STRIP_BYTE_COUNTS]
        raw = b"".join(decode(buf[o : o + c]) for o, c in zip(offsets, counts))
        # Strips always hold whole rows, so per-row undiff over the assembled
        # bytes is the per-chunk un-differencing.
        arr = assemble(raw, h, w)

    arr = arr.astype(arr.dtype.newbyteorder("="))

    profile = GeoProfile(width=w, height=h, dtype=str(arr.dtype))
    if _MODEL_PIXEL_SCALE in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        profile.pixel_size_x, profile.pixel_size_y = sx, sy
    if _MODEL_TIEPOINT in tags:
        tp = tags[_MODEL_TIEPOINT]
        profile.origin_x, profile.origin_y = tp[3], tp[4]
    if _GDAL_NODATA in tags:
        txt = tags[_GDAL_NODATA][0]
        try:
            profile.nodata = float(txt)
        except ValueError:
            profile.nodata = np.nan if "nan" in str(txt).lower() else None
    return np.array(arr), profile


def read_raster(path: Union[str, Path]) -> np.ndarray:
    """Array-only read (the dataset hot path)."""
    return read_geotiff(path)[0]
