"""Inputs made from the run's seed: a synthetic CRU-TS world for the sweep and
a WorldClim-like tile set for training.

:func:`make_globe` is a frozen copy of ``chip_smoke.py``'s ``make_globe``
(itself ``scripts/bench_whole_globe.py``'s world), given a seed and returning
the arrays it writes, so that the reference reads the same numbers as the
program without reading the program's files back.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def make_globe(root: Path, months: int, h: int, w: int, seed: int, scale: int = 4) -> Dict[str, np.ndarray]:
    """Synthetic CRU-TS world: NetCDF months with a polar ocean strip,
    elevation, and a smooth land mask thresholded at the real 29% land
    fraction (about 26% once the polar strip is ocean). Returns the arrays as
    written: ``data`` (months, h, w) south row first, ``mask`` (1 on land, NaN
    on ocean) and ``elevation`` at HR, north row first."""
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff
    from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series

    hr_h, hr_w = h * scale, w * scale
    strip = h // 9  # 40 of 360 rows
    rng = np.random.default_rng(seed)
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, :strip, :] = np.nan
    tstamps = np.array([f"{1901 + m // 12}-{m % 12 + 1:02d}-16" for m in range(months)], dtype="datetime64[D]")
    write_climate_series(
        root / "cru_ts4.05.1901.2020.tmp.dat.nc",
        ClimateSeries("tmp", data, tstamps, np.linspace(-89, 89, h), np.linspace(-179, 179, w)),
    )
    blob = max(1, hr_h // 36)
    field = rng.normal(size=(-(-hr_h // blob), -(-hr_w // blob))).astype(np.float32)
    field = np.kron(field, np.ones((blob, blob), np.float32))[:hr_h, :hr_w]
    for ax in (0, 1):  # cheap separable smoothing
        acc = np.zeros_like(field)
        for d in range(-(blob // 2), blob // 2 + 1):
            acc += np.roll(field, d, axis=ax)
        field = acc / (2 * (blob // 2) + 1)
    mask_hr = np.where(field >= np.quantile(field, 0.71), 1.0, np.nan).astype(np.float32)
    mask_hr[: strip * scale, :] = np.nan
    write_geotiff(root / "land_mask.tif", mask_hr, GeoProfile.global_grid(hr_h, hr_w))
    elev = rng.normal(500, 300, size=(hr_h, hr_w)).astype(np.float32)
    write_geotiff(root / "elevation.tif", elev, GeoProfile.global_grid(hr_h, hr_w, nodata=None))
    return {"data": data, "mask": mask_hr, "elevation": elev, "time": tstamps}


def make_tiles(n: int, size: int, seed: int, device: torch.device, chunk: int = 2048) -> Dict[str, np.ndarray]:
    """``n`` normalized HR tiles as a prepared WorldClim 2.5m set holds them
    (climate and elevation in [-1, 1] over land, 0 on ocean; the mask 1 on
    land), drawn on ``device`` from ``seed`` as smooth fields (8 x 8 noise,
    bicubic to ``size``) plus fine noise on the climate, and kept on the host:
    ``hr``, ``elevation`` (n, size, size) float32 and ``mask`` bool."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {"hr": np.empty((n, size, size), np.float32), "elevation": np.empty((n, size, size), np.float32),
           "mask": np.empty((n, size, size), bool)}
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        coarse = torch.randn(c, 3, 8, 8, generator=g, device=device)
        fields = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
        land = fields[:, 2] > -1.0
        hr = torch.tanh(fields[:, 0] + 0.1 * torch.randn(c, size, size, generator=g, device=device))
        elev = torch.tanh(fields[:, 1])
        out["hr"][i:i + c] = torch.where(land, hr, 0.0).cpu().numpy()
        out["elevation"][i:i + c] = torch.where(land, elev, 0.0).cpu().numpy()
        out["mask"][i:i + c] = land.cpu().numpy()
    return out
