# -*- coding: utf-8 -*-
"""The port's feather codec (``climsr_tpu_torch/io/feather.py``) against
pandas and pyarrow, which the JAX package writes its tables with.

- port -> port: every column type round-trips (utf8 with non-ASCII text and
  nulls, int32, int64, float32, float64 with NaN, bool, bool and ints with
  nulls, an all-null column), empty tables too;
- port -> pandas: ``pd.read_feather`` gives the same frame (dtype kind,
  values, NaN and None) with a ``RangeIndex``;
- pandas -> port, LZ4 (pyarrow's default) and uncompressed, several record
  batches and ``large_string`` included: equal to
  ``as_table(pd.read_feather(...))`` (pandas 3 holds a null string as NaN,
  the port as None: both are a null here), and ZSTD;
- the LZ4 frame decoder against pyarrow's compressor, and on a hand-made
  frame with a raw block, a match into the previous block, checksums and a
  skippable frame;
- random tables (hypothesis) through port -> pandas and pandas -> port.
"""
import struct
import warnings

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from climsr_tpu_torch.data.tables import Table, as_table, read_feather, write_feather
from climsr_tpu_torch.io import feather

torch.set_num_threads(1)


def _null(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def _same_column(got: np.ndarray, want: np.ndarray) -> bool:
    if got.dtype.kind != want.dtype.kind or len(got) != len(want):
        return False
    if want.dtype.kind == "f":
        return got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    if want.dtype == object:
        return all((_null(a) and _null(b)) or (not _null(a) and a == b) for a, b in zip(got, want))
    return got.dtype == want.dtype and np.array_equal(got, want)


def _assert_same(got: Table, want: Table) -> None:
    assert got.columns == want.columns
    for c in want.columns:
        assert _same_column(got[c], want[c]), (c, got[c], want[c])


def _to_pandas(path, **kw) -> Table:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        frame = pd.read_feather(path, **kw)
    assert isinstance(frame.index, pd.RangeIndex)
    return as_table(frame)


def _write_pandas(frame: pd.DataFrame, path, **kw) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        frame.to_feather(path, **kw)


def _columns(n: int = 7) -> dict:
    rng = np.random.default_rng(3)
    strings = np.array([f"/data/tiles/wc2.1_2.5m_tmin_{1961 + i}-01.{64 * i}.0.tif" for i in range(n)], object)
    strings[2] = "żółć ∑ non-ASCII"
    strings[4] = None
    floats = rng.normal(size=n)
    floats[1] = np.nan
    return {
        "path": strings,
        "i32": np.arange(n, dtype=np.int32) - 3,
        "i64": np.arange(n, dtype=np.int64) * 10**12,
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": floats,
        "flag": rng.random(n) > 0.5,
        "alt": np.array([402, None, 646] + [1] * (n - 3), object),
        "maybe": np.array([True, None, False] + [True] * (n - 3), object),
        "none": np.array([None] * n, object),
    }


# pandas reads an int column with nulls as float64; the codec reads it so too
_READ_BACK = {"alt": lambda v: np.array([np.nan if x is None else float(x) for x in v])}


@pytest.mark.parametrize("n", [0, 3, 7, 1000])
def test_port_round_trip_and_pandas_reads_it(tmp_path, n):
    cols = {k: v[:n] for k, v in _columns(max(n, 7)).items()}
    write_feather(Table(cols), tmp_path / "t.feather")
    want = Table({k: _READ_BACK.get(k, lambda v: v)(v) for k, v in cols.items()})
    if n == 0:  # no values: an object column is written as the null type, pandas' empty object column
        want = Table({k: (v.astype(object) if k in ("alt",) else v) for k, v in cols.items()})
    _assert_same(read_feather(tmp_path / "t.feather"), want)
    _assert_same(_to_pandas(tmp_path / "t.feather"), want)


@pytest.mark.parametrize("compression", ["lz4", "zstd", "uncompressed"])
def test_pandas_written_files_read_by_the_port(tmp_path, compression):
    n = 20_000
    frame = pd.DataFrame({
        "tile_file_path": [f"/data/pre-processed/world-clim/tiles/wc2.1/2.5m/tmin/"
                           f"wc2.1_2.5m_tmin_{1961 + i % 39}-{1 + i % 12:02d}.{64 * (i % 45)}.{64 * (i % 23)}.tif"
                           for i in range(n)],
        "variable": ["tmin"] * n,
        "year": np.arange(n) % 39 + 1961,
        "x": (np.arange(n) % 45 * 64).astype(np.int32),
        "min": np.linspace(-60, 40, n),
        "f32": np.linspace(0, 1, n, dtype=np.float32),
        "stage": pd.Series(["train", None, "val", "test"] * (n // 4), dtype=object),
        "ok": np.arange(n) % 3 == 0,
        "maybe": pd.Series([True, None, False, True] * (n // 4), dtype=object),
        "alt": [1, None, 3, 4] * (n // 4),
    })
    path = tmp_path / "pandas.feather"
    _write_pandas(frame, path, compression=compression, chunksize=7_000)  # several record batches
    assert ipc.open_file(path).num_record_batches == 3
    assert ipc.open_file(path).schema.field("tile_file_path").type == pa.large_string()
    _assert_same(read_feather(path), _to_pandas(path))


def test_zstd_raises_naming_the_codec(tmp_path):
    """ZSTD bodies (which the JAX package reads through pandas) are read
    since the port has its own zstd decoder; a file that is not feather
    still raises."""
    _write_pandas(pd.DataFrame({"a": [1, 2, 3], "s": ["x", None, "zz"]}), tmp_path / "z.feather", compression="zstd")
    _assert_same(read_feather(tmp_path / "z.feather"), _to_pandas(tmp_path / "z.feather"))
    (tmp_path / "x.feather").write_bytes(b"not a feather file at all")
    with pytest.raises(ValueError, match="not a feather"):
        read_feather(tmp_path / "x.feather")


@pytest.mark.parametrize("size", [0, 1, 300, 70_000, 300_000])
def test_lz4_frames_from_pyarrow(size):
    rng = np.random.default_rng(size)
    data = (b"wc2.1_2.5m_tmin_1999-01." * (size // 24 + 1))[:size // 2] + rng.bytes(size - size // 2)
    frame = pa.compress(data, codec="lz4", asbytes=True)
    assert feather.lz4_frame_decompress(frame) == data


def test_lz4_frame_by_hand():
    def block(payload: bytes, raw: bool = False) -> bytes:
        return struct.pack("<I", len(payload) | (0x80000000 if raw else 0)) + payload + b"\0\0\0\0"  # + checksum

    flg = 0x40 | 0x10 | 0x04  # version 01, block checksums, content checksum; linked blocks
    header = struct.pack("<I", 0x184D2204) + bytes([flg, 0x40, 0])
    # block 2: no literals, a match of 8 at offset 8 (into block 1), then a run
    # of 'a' (overlapping match, offset 1), then the closing literals
    seq = bytes([0x04]) + struct.pack("<H", 8) + bytes([0x1F]) + b"a" + struct.pack("<H", 1) + bytes([2])
    seq += bytes([0x20]) + b"YZ"
    frame = header + block(b"abcdefgh", raw=True) + block(seq) + struct.pack("<I", 0) + b"\0\0\0\0"
    skippable = struct.pack("<II", 0x184D2A50, 3) + b"xyz"
    assert feather.lz4_frame_decompress(skippable + frame) == b"abcdefgh" * 2 + b"a" * 22 + b"YZ"


_cell_strategies = {
    "str": st.one_of(st.none(), st.text(max_size=12)),
    "i64": st.integers(-2**62, 2**62),
    "f64": st.one_of(st.floats(allow_nan=True, allow_infinity=True), st.just(float("nan"))),
    "bool": st.booleans(),
}


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data(), n=st.integers(0, 30), kinds=st.lists(st.sampled_from(sorted(_cell_strategies)),
                                                              min_size=1, max_size=4))
def test_random_tables_both_ways(tmp_path, data, n, kinds):
    cols = {}
    for i, kind in enumerate(kinds):
        values = data.draw(st.lists(_cell_strategies[kind], min_size=n, max_size=n))
        if kind == "str":
            arr = np.empty(n, object)
            arr[:] = values
        else:
            arr = np.array(values, {"i64": np.int64, "f64": np.float64, "bool": bool}[kind])
        cols[f"{kind}{i}"] = arr
    table = Table(cols)
    write_feather(table, tmp_path / "port.feather")
    if n == 0:
        cols = {k: (v.astype(object) if v.dtype == object else v) for k, v in cols.items()}
    _assert_same(read_feather(tmp_path / "port.feather"), Table(cols))
    _assert_same(_to_pandas(tmp_path / "port.feather"), Table(cols))
    _write_pandas(pd.DataFrame(cols), tmp_path / "pandas.feather")
    _assert_same(read_feather(tmp_path / "pandas.feather"), _to_pandas(tmp_path / "pandas.feather"))
