# -*- coding: utf-8 -*-
"""NetCDF IO without libnetcdf/xarray: scipy's pure-python NetCDF3 engine.

The reference reads CRU-TS NetCDF with xarray (``cruts_inference_dataset.py:40``)
and exports SR series as CF-1.4 NetCDF (``inference/inference.py:224-243``).
CRU-TS 4.05 ships as NetCDF3-classic, which ``scipy.io.netcdf_file`` handles
natively; this module wraps it with the small schema the pipeline needs:

- :class:`ClimateSeries` — (time, lat, lon) cube with datetime64 time axis,
- :func:`read_climate_series` — loads a variable + coords, decoding CF time
  units ("days since YYYY-MM-DD") and masking ``_FillValue``/``missing_value``,
- :func:`write_climate_series` — CF-1.4 export matching the reference's
  attribute set (Conventions/title/source/extent).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
from scipy.io import netcdf_file


@dataclasses.dataclass
class ClimateSeries:
    variable: str
    data: np.ndarray  # (time, lat, lon) float32, NaN = missing
    time: np.ndarray  # datetime64[D]
    lat: np.ndarray
    lon: np.ndarray


def _decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    units = units.strip()
    parts = units.split("since")
    if len(parts) != 2:
        raise ValueError(f"Unsupported time units: {units!r}")
    step = parts[0].strip().lower()
    # CF origins are often not zero-padded — CRU-TS 4.05 ships
    # "days since 1900-1-1", which np.datetime64 rejects; normalize to ISO
    date_str = parts[1].strip().split()[0]
    # a time-of-day may ride on the date with an ISO 'T' instead of a space
    # ("days since 1900-01-01T00:00:00") — truncate it like the space form
    date_str = date_str.split("T")[0]
    ymd = date_str.split("-")
    if len(ymd) == 3:
        date_str = f"{int(ymd[0]):04d}-{int(ymd[1]):02d}-{int(ymd[2]):02d}"
    origin = np.datetime64(date_str)
    step_map = {"days": "D", "day": "D", "hours": "h", "hour": "h", "months": "M", "month": "M"}
    if step not in step_map:
        raise ValueError(f"Unsupported time step: {step!r}")
    unit = step_map[step]
    if unit == "M":
        return (origin.astype("datetime64[M]") + values.astype("timedelta64[M]")).astype("datetime64[D]")
    return (origin.astype(f"datetime64[{unit}]") + values.astype(f"timedelta64[{unit}]")).astype("datetime64[D]")


def read_climate_series(path: Union[str, Path], variable: str) -> ClimateSeries:
    with netcdf_file(str(path), "r", mmap=False) as nc:
        var = nc.variables[variable]
        data = np.array(var[:], dtype=np.float32)
        for attr in ("_FillValue", "missing_value"):
            fill = getattr(var, attr, None)
            if fill is not None:
                data = np.where(np.isclose(data, np.float32(fill)), np.nan, data)
        scale = getattr(var, "scale_factor", None)
        offset = getattr(var, "add_offset", None)
        if scale is not None:
            data = data * np.float32(scale)
        if offset is not None:
            data = data + np.float32(offset)

        time_var = nc.variables["time"]
        units = time_var.units
        if isinstance(units, bytes):
            units = units.decode()
        time = _decode_cf_time(np.array(time_var[:]), units)
        lat = np.array(nc.variables["lat"][:], dtype=np.float64)
        lon = np.array(nc.variables["lon"][:], dtype=np.float64)
    return ClimateSeries(variable=variable, data=data, time=time, lat=lat, lon=lon)


def write_climate_series(
    path: Union[str, Path],
    series: ClimateSeries,
    title: Optional[str] = None,
    source: str = "Neural-Downscaling approach.",
    extent: str = "Europe. Based on ETRS89.",
    fill_value: float = 9.96921e36,
) -> None:
    """Write a CF-1.4 (time, lat, lon) float32 cube as NetCDF3-classic."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = np.asarray(series.data, dtype=np.float32)
    t, h, w = data.shape

    with netcdf_file(str(path), "w") as nc:
        nc.Conventions = b"CF-1.4"
        if title:
            nc.title = title.encode()
        nc.source = source.encode()
        nc.extent = extent.encode()

        nc.createDimension("time", t)
        nc.createDimension("lat", h)
        nc.createDimension("lon", w)

        origin = np.datetime64("1900-01-01")
        tv = nc.createVariable("time", "i", ("time",))
        tv[:] = (series.time.astype("datetime64[D]") - origin).astype("timedelta64[D]").astype(np.int32)
        tv.units = b"days since 1900-01-01"
        tv.calendar = b"gregorian"

        latv = nc.createVariable("lat", "d", ("lat",))
        latv[:] = np.asarray(series.lat, dtype=np.float64)
        latv.units = b"degrees_north"
        lonv = nc.createVariable("lon", "d", ("lon",))
        lonv[:] = np.asarray(series.lon, dtype=np.float64)
        lonv.units = b"degrees_east"

        v = nc.createVariable(series.variable, "f", ("time", "lat", "lon"))
        filled = np.where(np.isnan(data), np.float32(fill_value), data)
        v[:] = filled
        v.missing_value = np.float32(fill_value)
        v._FillValue = np.float32(fill_value)


def stack_monthly_rasters(
    arrays: Sequence[np.ndarray],
    timestamps: Sequence[np.datetime64],
    lat: np.ndarray,
    lon: np.ndarray,
    variable: str,
) -> ClimateSeries:
    """Stack per-month rasters (the GeoTIFF->NetCDF path, inference.py:199-235)."""
    data = np.stack([np.asarray(a, dtype=np.float32) for a in arrays], axis=0)
    return ClimateSeries(
        variable=variable,
        data=data,
        time=np.asarray(timestamps, dtype="datetime64[D]"),
        lat=np.asarray(lat),
        lon=np.asarray(lon),
    )
