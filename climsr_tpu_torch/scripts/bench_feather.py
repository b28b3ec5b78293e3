# -*- coding: utf-8 -*-
"""The feather codec's speed on a split table of real size, on the host.

One variable's train split at the real grid (2880 x 1440, 128-px tiles at
stride 64: 45 x 23 windows a raster) over 1961-1999 holds up to 484,380
rows; the table here takes the first 400,000, in the layout
``run_train_val_test_split`` writes (tile path, file name, variable, year,
month, resolution, x, y, stage).

- ``--make PATH`` writes that table with pandas (pyarrow's default LZ4
  compression, as the JAX package writes it); it needs pandas and pyarrow.
- ``PATH`` alone reads it with the port's codec (``io/feather.py``: the LZ4
  frames decoded in pure Python), writes it uncompressed with the port and
  reads that back; each three times. Prints rows/s (median) for each, the
  host's CPU count and, where ``nvidia-smi`` answers, the card's name and
  power limit, then one JSON line.

Usage: ``python -m climsr_tpu_torch.scripts.bench_feather --make split.feather``
(where pandas is), then ``python -m climsr_tpu_torch.scripts.bench_feather
split.feather``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from itertools import product
from pathlib import Path

import numpy as np

from climsr_tpu_torch.io import feather

ROWS = 400_000
REPEATS = 3


def split_table(rows: int = ROWS) -> dict:
    offsets = list(product(range(0, 2880, 64), range(0, 1440, 64)))
    base = "/datasets/pre-processed/world-clim/tiles/wc2.1/2.5m/tmin/"
    cols = {k: [] for k in ("tile_file_path", "filename", "variable", "year", "month", "resolution", "x", "y",
                            "stage")}
    for year, month in product(range(1961, 2000), range(1, 13)):
        name = f"wc2.1_2.5m_tmin_{year}-{month:02d}.tif"
        for x, y in offsets:
            for k, v in zip(cols, (f"{base}{name[:-4]}.{x}.{y}.tif", name, "tmin", year, month, "2.5m", x, y,
                                   "train")):
                cols[k].append(v)
            if len(cols["x"]) == rows:
                return {k: np.asarray(v, object if isinstance(v[0], str) else np.int64) for k, v in cols.items()}
    raise ValueError(f"the split holds fewer than {rows} rows")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def timed(fn) -> float:
    times = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("path")
    parser.add_argument("--make", action="store_true", help="write the LZ4 table with pandas")
    args = parser.parse_args(argv)
    if args.make:
        import pandas as pd

        pd.DataFrame(split_table()).to_feather(args.path)  # pyarrow's default: LZ4_FRAME
        print(f"wrote {ROWS} rows to {args.path} ({os.path.getsize(args.path)} bytes)")
        return {}
    rows = len(feather.read(args.path)["x"])
    result = dict(rows=rows, lz4_bytes=os.path.getsize(args.path), cpus=os.cpu_count(), card=card_line(),
                  python=sys.version.split()[0])
    result["lz4_read_s"] = timed(lambda: feather.read(args.path))
    cols = feather.read(args.path)
    with tempfile.TemporaryDirectory() as tmp:
        raw = Path(tmp) / "raw.feather"
        result["write_s"] = timed(lambda: feather.write(cols, raw))
        result["raw_bytes"] = raw.stat().st_size
        result["raw_read_s"] = timed(lambda: feather.read(raw))
        again = feather.read(raw)
    if any(not np.array_equal(again[k], v) for k, v in cols.items()):
        raise AssertionError("the uncompressed copy does not read back equal")
    for k in ("lz4_read", "write", "raw_read"):
        result[f"{k}_rows_per_s"] = rows / result[f"{k}_s"]
    print(f"# feather, {rows} rows: LZ4 read {result['lz4_read_rows_per_s']:.0f} rows/s "
          f"({result['lz4_read_s']:.3f} s, {result['lz4_bytes']} bytes), uncompressed write "
          f"{result['write_rows_per_s']:.0f} rows/s, read {result['raw_read_rows_per_s']:.0f} rows/s "
          f"({result['raw_bytes']} bytes); median of {REPEATS}; {result['cpus']} CPUs; {result['card']}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
