# -*- coding: utf-8 -*-
"""Offline ETL: the 7-step preprocessing pipeline (CRU-TS + WorldClim), the
port of ``climsr_tpu/preprocessing/preprocessing.py``.

1. ``run_cruts_to_tiff`` — CRU-TS NetCDF -> per-month GeoTIFF + feather index,
2. ``run_world_clim_resize`` — resize WorldClim rasters to 2880x1440 @0.125°,
   nearest, unify missing indicators to NaN,
3. ``run_tavg_rasters_generation`` — tavg = (tmin + tmax) / 2,
4. ``run_world_clim_tiling`` — 128x128 tiles, stride 64, edge snap-back, drop
   tiles with > 85% NaN (except elevation),
5. ``run_statistics_computation`` — z-score stats per variable ('temp' = mean
   of the temperature vars) and per-file + global min/max stats,
6. ``run_train_val_test_split`` — year-based split (train 1961-1999 ∪
   future >= 2020; val 2000-2005; test 2006-2020), val/test restricted to
   non-overlapping tiles (x % 128 == 0 and y % 128 == 0),
7. ``run_extent_extraction`` — Europe bbox crop (-16..40.5 lon, 28..84.5 lat)
   of CRU-TS + WorldClim rasters + extent-level split feathers.

The steps, their outputs and the file layout are the JAX package's. It stays
on the host, numpy and a process pool as there, with three changes of means:
the nearest resize is the native library's (``nearest_resize_native``, cv2's
``INTER_NEAREST`` index rule in integer arithmetic) in place of cv2; the
statistics' pandas ``groupby``/``map``/``concat`` are numpy over
:class:`~climsr_tpu_torch.data.tables.Table` columns; feathers are written by
the port's own codec. The pool starts its workers with ``spawn`` (a caller
may hold CUDA and loader threads, which ``fork`` would copy half-way), so
each worker function is top-level and gets the run-time values it needs
(the target grid) as arguments. This module imports no torch.
"""
from __future__ import annotations

import contextlib
import logging
import multiprocessing
import os
import re
import warnings
from concurrent.futures import ProcessPoolExecutor
from dataclasses import asdict, dataclass
from glob import glob
from itertools import product
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.tables import Table, write_feather
from climsr_tpu_torch.io.geotiff import GeoProfile, read_geotiff, write_geotiff
from climsr_tpu_torch.native import load_native, native_error, nearest_resize_native

if TYPE_CHECKING:  # the schemas import torch; the pool's workers must not
    from climsr_tpu_torch.config.schemas import PreProcessingConfig

D = consts.datasets_and_preprocessing
S = consts.stats
WC = consts.world_clim
logger = logging.getLogger(__name__)

year_pattern = re.compile(r"(\d\d\d\d)")
month_pattern = re.compile(r"[-_](\d\d)\.")


@dataclass
class StatsContainer:
    variable: str
    mean: float
    std: float
    min: float
    max: float
    normalized_min: float
    normalized_max: float


def _is_future(year: int) -> bool:
    return year >= 2020


def _year_from_filename(fname: str) -> int:
    match = re.search(year_pattern, fname)
    return int(match.group()) if match is not None else -1


def _month_from_filename(fname: str) -> int:
    match = re.search(month_pattern, fname)
    return int(match.group().replace(".", "").replace("_", "").replace("-", "")) if match is not None else -1


def _resolution_from_filename(fname: str) -> Optional[str]:
    for res in WC.data_resolutions:
        if res in fname:
            return res
    return None


@contextlib.contextmanager
def worker_pool(n_workers: int) -> Iterator[Optional[ProcessPoolExecutor]]:
    """One ``spawn`` pool for several steps (None at one worker): a spawned
    worker pays an interpreter start and the imports, so a run of the seven
    steps starts its workers once."""
    if n_workers <= 1:
        yield None
        return
    with ProcessPoolExecutor(max_workers=n_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def _parallel_map(fn: Callable, items: Sequence, pool: Optional[ProcessPoolExecutor], n_workers: int) -> List:
    """``fn`` over ``items`` in the caller's ``pool`` of ``n_workers``;
    serially without a pool or below 4 items."""
    if pool is None or len(items) < 4:
        return [fn(item) for item in items]
    return list(pool.map(fn, items, chunksize=max(1, len(items) // (n_workers * 4))))


def _write_table(rows: List[tuple], columns: Sequence[str], path: Path) -> None:
    write_feather(Table({c: [r[i] for r in rows] for i, c in enumerate(columns)}), path)


# -- step 1: CRU-TS NetCDF -> monthly GeoTIFFs --------------------------------
def _cruts_as_tiff(variable: str, data_dir: str, out_dir: str, df_output_path: str) -> None:
    from climsr_tpu_torch.io.netcdf import read_climate_series  # scipy: kept out of the pool's workers

    fp = os.path.join(data_dir, consts.cruts.file_pattern.format(variable))
    out_path = Path(out_dir) / consts.cruts.full_res_dir / variable
    out_path.mkdir(parents=True, exist_ok=True)
    feather_dir = Path(df_output_path) / D.feather_path
    feather_dir.mkdir(parents=True, exist_ok=True)

    series = read_climate_series(fp, variable)
    h, w = series.data.shape[1:]
    profile = GeoProfile(
        width=w,
        height=h,
        origin_x=float(series.lon.min()) - consts.cruts.degree_per_pix / 2,
        origin_y=float(series.lat.max()) + consts.cruts.degree_per_pix / 2,
        pixel_size_x=consts.cruts.degree_per_pix,
        pixel_size_y=consts.cruts.degree_per_pix,
        nodata=np.nan,
    )
    file_paths = []
    for i in range(series.data.shape[0]):
        date_str = np.datetime_as_string(series.time[i], unit="D")
        fname = str(out_path / f"cruts-{variable}-{date_str}.tif")
        # NetCDF lat ascends south->north; GeoTIFF row 0 is the north edge
        write_geotiff(fname, np.flipud(series.data[i]).astype(np.float32), profile)
        file_paths.append(fname)
    write_feather(Table({D.file_path: file_paths}), feather_dir / f"{variable}.feather")


def run_cruts_to_tiff(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_cruts_to_tiff:
        return
    logger.info("Running CRU-TS pre-processing - GeoTIFF generation")
    out_dir = os.path.join(cfg.output_path, D.preprocessing_output_path, D.cruts_preprocessing_out_path)
    df_dir = os.path.join(cfg.output_path, D.preprocessing_output_path)
    for var in consts.cruts.temperature_vars:
        _cruts_as_tiff(var, cfg.data_dir_cruts, out_dir, df_dir)


# -- step 2: WorldClim resize to target HR ------------------------------------
def _resize_one(args: Tuple[str, str, str, int, int]) -> None:
    file_path, out_dir, remove_path, target_w, target_h = args
    arr, profile = read_geotiff(file_path)
    arr = arr.astype(np.float32)
    data = nearest_resize_native(arr, target_h, target_w)
    for missing in WC.missing_indicators:
        data[data == missing] = WC.target_missing_indicator

    rel = file_path.replace(remove_path, "").strip("/")
    out_fp = Path(out_dir) / WC.resized_dir / rel
    out_fp.parent.mkdir(parents=True, exist_ok=True)
    out_profile = GeoProfile(
        width=target_w,
        height=target_h,
        origin_x=profile.origin_x,
        origin_y=profile.origin_y,
        pixel_size_x=0.125,
        pixel_size_y=0.125,
        nodata=np.nan,
    )
    write_geotiff(out_fp, data, out_profile)


def run_world_clim_resize(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_world_clim_resize:
        return
    files = sorted(glob(os.path.join(cfg.data_dir_world_clim, "**", WC.pattern_wc), recursive=True))
    logger.info("WorldClim resize to %s: %d files", WC.target_hr_resolution, len(files))
    if load_native() is None:  # built here once, before the pool's workers load it
        raise RuntimeError(f"the WorldClim resize needs the native library: {native_error()}")
    out_dir = os.path.join(cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path)
    target_w, target_h = WC.target_hr_resolution
    _parallel_map(_resize_one, [(fp, out_dir, cfg.data_dir_world_clim, target_w, target_h) for fp in files],
                  pool, cfg.n_workers)


# -- step 3: tavg generation --------------------------------------------------
def _generate_tavg_raster(tmin_fname: str) -> None:
    out_fname = tmin_fname.replace(f"/{WC.tmin}/", f"/{WC.tavg}/").replace(f"_{WC.tmin}_", f"_{WC.tavg}_")
    tmax_fname = tmin_fname.replace(f"/{WC.tmin}/", f"/{WC.tmax}/").replace(f"_{WC.tmin}_", f"_{WC.tmax}_")
    if os.path.exists(out_fname):
        logger.warning("Conflict! File %s already exists. tavg raster will not be generated.", out_fname)
        return
    try:
        tmin_arr, profile = read_geotiff(tmin_fname)
        tmax_arr, _ = read_geotiff(tmax_fname)
        tavg = ((tmin_arr.astype(np.float64) + tmax_arr.astype(np.float64)) / 2.0).astype(np.float32)
        Path(out_fname).parent.mkdir(parents=True, exist_ok=True)
        write_geotiff(out_fname, tavg, profile)
    except (OSError, ValueError) as ex:  # a tmin without its tmax pair, as the reference tolerates
        logger.info("Generation of tavg raster failed: %s", ex)


def run_tavg_rasters_generation(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_tavg_rasters_generation:
        return
    pattern = os.path.join(
        cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path,
        WC.resized_dir, "**", f"*{WC.tmin}*.tif",
    )
    tmin_files = sorted(glob(pattern, recursive=True))
    logger.info("tavg generation: %d tmin rasters", len(tmin_files))
    _parallel_map(_generate_tavg_raster, tmin_files, pool, cfg.n_workers)


# -- step 4: tiling -----------------------------------------------------------
def _tile_windows(width: int, height: int, tile_w: int, tile_h: int, stride: int):
    """Window origins with edge snap-back (reference _get_tiles:161-203)."""
    for col_off, row_off in product(range(0, width, stride or tile_w), range(0, height, stride or tile_h)):
        if width - col_off < tile_w:
            col_off = width - tile_w
        if height - row_off < tile_h:
            row_off = height - tile_h
        yield col_off, row_off


def _make_patches(args: Tuple[str, str, Tuple[int, int], int]) -> None:
    file_path, out_path, tile_shape, stride = args
    arr, profile = read_geotiff(file_path)
    arr = arr.astype(np.float32)
    tile_w, tile_h = tile_shape
    h, w = arr.shape

    # keep the folder structure below the wc2.1 extraction dir (reference :224-226)
    marker = D.world_clim_main_extraction_folder
    idx = file_path.find(marker)
    sub_dir = os.path.dirname(file_path)[idx:] if idx >= 0 else Path(file_path).parent.name
    out_dir = Path(out_path) / sub_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(file_path).stem

    for col_off, row_off in _tile_windows(w, h, tile_w, tile_h, stride):
        subset = arr[row_off : row_off + tile_h, col_off : col_off + tile_w]
        if np.count_nonzero(np.isnan(subset)) / subset.size > 0.85 and "elev" not in file_path:
            continue
        tile_profile = GeoProfile(
            width=tile_w,
            height=tile_h,
            origin_x=profile.origin_x + col_off * profile.pixel_size_x,
            origin_y=profile.origin_y - row_off * profile.pixel_size_y,
            pixel_size_x=profile.pixel_size_x,
            pixel_size_y=profile.pixel_size_y,
            nodata=np.nan,
        )
        write_geotiff(out_dir / f"{stem}.{col_off}.{row_off}.tif", subset, tile_profile)


def run_world_clim_tiling(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_world_clim_tiling:
        return
    base = os.path.join(cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path)
    files = sorted(glob(os.path.join(base, WC.resized_dir, "**", WC.pattern_wc), recursive=True))
    logger.info("WorldClim tiling: %d files", len(files))
    out_path = os.path.join(base, WC.tiles_dir)
    _parallel_map(
        _make_patches, [(fp, out_path, tuple(cfg.patch_size), cfg.patch_stride) for fp in files], pool, cfg.n_workers
    )


# -- step 5: statistics -------------------------------------------------------
def _clean_missing(arr: np.ndarray) -> np.ndarray:
    arr = arr.astype(np.float64)
    for missing in WC.missing_indicators:
        arr[arr == missing] = WC.target_missing_indicator
    return arr


def _stats_common(variable: str, arr: np.ndarray) -> StatsContainer:
    arr = _clean_missing(arr)
    mean = float(np.nanmean(arr))
    std = float(np.nanstd(arr))
    vmin = float(np.nanmin(arr))
    vmax = float(np.nanmax(arr))
    return StatsContainer(
        variable=variable,
        mean=mean,
        std=std,
        min=vmin,
        max=vmax,
        normalized_min=(vmin - mean) / (std + 1e-8),
        normalized_max=(vmax - mean) / (std + 1e-8),
    )


def _stats_for_file(args: Tuple[str, str]) -> StatsContainer:
    fp, var = args
    arr, _ = read_geotiff(fp)
    return _stats_common(var, arr)


def _minmax_for_file(fp: str) -> Tuple[float, float]:
    arr, _ = read_geotiff(fp)
    arr = _clean_missing(arr)
    return float(np.nanmin(arr)), float(np.nanmax(arr))


def _skipna(reduce: Callable, values: Sequence[float]) -> float:
    """pandas' ``Series.mean/min/max()``: NaN skipped, NaN where nothing is left."""
    values = np.asarray(values, np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(reduce(values))


def _pooled(variable: str, records: Sequence[StatsContainer]) -> StatsContainer:
    """One variable's statistics from per-file (or per-variable) records: the
    mean of the means and of the stds, the least min, the largest max."""
    def col(name):
        return [getattr(r, name) for r in records]

    return StatsContainer(
        variable=variable,
        mean=_skipna(np.nanmean, col(S.mean)),
        std=_skipna(np.nanmean, col(S.std)),
        min=_skipna(np.nanmin, col(S.min)),
        max=_skipna(np.nanmax, col(S.max)),
        normalized_min=_skipna(np.nanmin, col(S.normalized_min)),
        normalized_max=_skipna(np.nanmax, col(S.normalized_max)),
    )


def _compute_stats_for_zscore(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_z_score_stats_computation:
        return
    from climsr_tpu_torch.io.netcdf import read_climate_series

    logger.info("Running statistical computation for z-score")
    results: List[StatsContainer] = []
    for var in consts.cruts.temperature_vars:
        series = read_climate_series(
            os.path.join(cfg.data_dir_cruts, consts.cruts.file_pattern.format(var)), var
        )
        results.append(_stats_common(var, series.data))

    for var in WC.temperature_vars + [WC.elev]:
        files = glob(
            os.path.join(
                cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path,
                WC.resized_dir, "**", f"*{var}*.tif",
            ),
            recursive=True,
        )
        if not files:
            continue
        records = _parallel_map(_stats_for_file, [(fp, var) for fp in files], pool, cfg.n_workers)
        results.append(_pooled(var, records))

    results.append(_pooled(WC.temp, [r for r in results if r.variable != WC.elev]))
    out_dir = Path(cfg.output_path) / D.preprocessing_output_path / D.feather_path
    out_dir.mkdir(parents=True, exist_ok=True)
    write_feather(Table.from_rows(asdict(r) for r in results), out_dir / D.zscore_stats_filename)


def _compute_stats_for_min_max_normalization(cfg: "PreProcessingConfig",
                                             pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_min_max_stats_computation:
        return
    logger.info("Running statistical computation for min-max normalization")
    results: List[Tuple] = []

    for var in consts.cruts.temperature_vars:
        files = sorted(
            glob(
                os.path.join(
                    cfg.output_path, D.preprocessing_output_path, D.cruts_preprocessing_out_path,
                    consts.cruts.full_res_dir, var, "*.tif",
                )
            )
        )
        minmaxes = _parallel_map(_minmax_for_file, files, pool, cfg.n_workers)
        for fp, (vmin, vmax) in zip(files, minmaxes):
            name = os.path.basename(fp)
            results.append(
                ("cru-ts", fp, name, var, int(name.split("-")[-3]), int(name.split("-")[-2]), "30m", vmin, vmax)
            )

    for var in WC.temperature_vars + [WC.elev]:
        files = sorted(
            glob(
                os.path.join(
                    cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path,
                    WC.resized_dir, "**", f"*{var}*.tif",
                ),
                recursive=True,
            )
        )
        minmaxes = _parallel_map(_minmax_for_file, files, pool, cfg.n_workers)
        for fp, (vmin, vmax) in zip(files, minmaxes):
            fname = os.path.basename(fp)
            results.append(
                (
                    "world-clim", fp, fname, var,
                    _year_from_filename(fname), _month_from_filename(fname), _resolution_from_filename(fname),
                    vmin, vmax,
                )
            )

    # global min/max per variable, with the cross-variable pooling quirk: the
    # reference seeds the pool with 0.0 (preprocessing.py:484-495), so global
    # min <= 0 and max >= 0 for temperature groups — kept for parity.
    lookup: Dict[str, Dict[str, float]] = {
        var: {S.global_min: _skipna(np.nanmin, [r[7] for r in results if r[3] == var]),
              S.global_max: _skipna(np.nanmax, [r[8] for r in results if r[3] == var])}
        for var in sorted({r[3] for r in results})
    }
    cruts_min = cruts_max = wc_min = wc_max = 0.0
    for key, val in lookup.items():
        if key in consts.cruts.temperature_vars:
            cruts_min = min(cruts_min, val[S.global_min])
            cruts_max = max(cruts_max, val[S.global_max])
        if key in WC.temperature_vars:
            wc_min = min(wc_min, val[S.global_min])
            wc_max = max(wc_max, val[S.global_max])
    for key, val in lookup.items():
        if key in consts.cruts.temperature_vars:
            val[S.global_min], val[S.global_max] = cruts_min, cruts_max
        if key in WC.temperature_vars:
            val[S.global_min], val[S.global_max] = wc_min, wc_max

    rows = [r + (lookup[r[3]][S.global_min], lookup[r[3]][S.global_max]) for r in results]
    columns = [D.dataset, D.file_path, D.filename, D.variable, D.year, D.month, D.resolution, S.min, S.max,
               S.global_min, S.global_max]
    out_dir = Path(cfg.output_path) / D.preprocessing_output_path / D.feather_path
    out_dir.mkdir(parents=True, exist_ok=True)
    _write_table(rows, columns, out_dir / D.min_max_stats_filename)


def run_statistics_computation(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_statistics_computation:
        return
    logger.info("Running statistics computation")
    _compute_stats_for_zscore(cfg, pool)
    _compute_stats_for_min_max_normalization(cfg, pool)


# -- step 6: train/val/test split ---------------------------------------------
def run_train_val_test_split(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_train_val_test_split:
        return
    variables = WC.temperature_vars + [WC.elev]
    ncols, nrows = WC.target_hr_resolution
    offsets = list(
        product(
            range(0, ncols, cfg.patch_stride or ncols),
            range(0, nrows, cfg.patch_stride or nrows),
        )
    )
    train_lo, train_hi = cfg.train_years
    val_lo, val_hi = cfg.val_years
    test_lo, test_hi = cfg.test_years

    base = os.path.join(cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path)
    feather_base = Path(cfg.output_path) / D.preprocessing_output_path / D.feather_path
    columns = [D.tile_file_path, D.filename, D.variable, D.year, D.month, D.resolution, D.x, D.y, D.stage]

    for variable in variables:
        (feather_base / variable).mkdir(parents=True, exist_ok=True)
        original_rasters = sorted(glob(os.path.join(base, WC.resized_dir, "**", f"*{variable}*.tif"), recursive=True))
        records = []
        for fp in original_rasters:
            original_filename = os.path.basename(fp)
            year = _year_from_filename(original_filename)
            month = _month_from_filename(original_filename)
            resolution = _resolution_from_filename(original_filename)
            tile_base = fp.replace(".tif", "").replace(WC.resized_dir, WC.tiles_dir)
            for x, y in offsets:
                tile_fp = f"{tile_base}.{x}.{y}.tif"
                if not os.path.exists(tile_fp):
                    continue
                if (train_lo <= year <= train_hi) or _is_future(year):
                    stage = consts.stages.train
                # non-overlap guard axes match _make_patches: patch_size[0] is
                # tile WIDTH (x/col axis), patch_size[1] tile HEIGHT (y/row)
                elif (val_lo <= year <= val_hi) and x % cfg.patch_size[0] == 0 and y % cfg.patch_size[1] == 0:
                    stage = consts.stages.val
                elif (test_lo <= year <= test_hi) and x % cfg.patch_size[0] == 0 and y % cfg.patch_size[1] == 0:
                    stage = consts.stages.test
                elif WC.elev in tile_fp:
                    stage = WC.elev
                else:
                    stage = ""
                records.append((tile_fp, original_filename, variable, year, month, resolution, x, y, stage))

        for stage in [consts.stages.train, consts.stages.val, consts.stages.test, WC.elev]:
            stage_rows = [r for r in records if r[-1] == stage]
            if not stage_rows:
                continue
            out_name = f"{stage}.feather" if stage != WC.elev else f"{WC.elev}.feather"
            _write_table(stage_rows, columns, feather_base / variable / out_name)
            logger.info("Generated %d %s images for variable: %s", len(stage_rows), stage, variable)


# -- step 7: Europe extent extraction -----------------------------------------
def _bbox_to_window(profile: GeoProfile, bbox: Tuple[Tuple[float, float], Tuple[float, float]]):
    """((min_lon, max_lat), (max_lon, min_lat)) -> (row0, row1, col0, col1)."""
    (min_lon, max_lat), (max_lon, min_lat) = bbox
    col0 = int(round((min_lon - profile.origin_x) / profile.pixel_size_x))
    col1 = int(round((max_lon - profile.origin_x) / profile.pixel_size_x))
    row0 = int(round((profile.origin_y - max_lat) / profile.pixel_size_y))
    row1 = int(round((profile.origin_y - min_lat) / profile.pixel_size_y))
    return max(row0, 0), row1, max(col0, 0), col1


def _extract_extent_single(args: Tuple[str, Any, str, str]) -> None:
    fp, bbox, variable, extent_out_path = args
    arr, profile = read_geotiff(fp)
    row0, row1, col0, col1 = _bbox_to_window(profile, bbox)
    crop = arr[row0:row1, col0:col1]
    crop_profile = GeoProfile(
        width=crop.shape[1],
        height=crop.shape[0],
        origin_x=profile.origin_x + col0 * profile.pixel_size_x,
        origin_y=profile.origin_y - row0 * profile.pixel_size_y,
        pixel_size_x=profile.pixel_size_x,
        pixel_size_y=profile.pixel_size_y,
        nodata=profile.nodata,
    )
    out = Path(extent_out_path) / variable / os.path.basename(fp)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_geotiff(out, crop, crop_profile)


def run_extent_extraction(cfg: "PreProcessingConfig", pool: Optional[ProcessPoolExecutor] = None) -> None:
    if not cfg.run_extent_extraction:
        return
    bbox = D.europe_bbox_lr  # ((min_lon, max_lat), (max_lon, min_lat))

    cruts_base = os.path.join(cfg.output_path, D.preprocessing_output_path, D.cruts_preprocessing_out_path)
    extent_dir = os.path.join(cruts_base, consts.cruts.europe_extent)
    logger.info("Extracting Europe extents for CRU-TS files")
    for var in consts.cruts.temperature_vars:
        files = sorted(glob(os.path.join(cruts_base, consts.cruts.full_res_dir, var, "*.tif")))
        _parallel_map(_extract_extent_single, [(fp, bbox, var, extent_dir) for fp in files], pool, cfg.n_workers)

    wc_base = os.path.join(cfg.output_path, D.preprocessing_output_path, D.world_clim_preprocessing_out_path)
    wc_extent_dir = os.path.join(wc_base, consts.cruts.europe_extent)
    logger.info("Extracting Europe extents for WorldClim files")
    for var in WC.temperature_vars + [WC.elev]:
        files = sorted(glob(os.path.join(wc_base, WC.resized_dir, "**", f"*{var}*.tif"), recursive=True))
        _parallel_map(_extract_extent_single, [(fp, bbox, var, wc_extent_dir) for fp in files], pool, cfg.n_workers)

    logger.info("Train/Val/Test split on Europe extent files")
    feather_base = Path(cfg.output_path) / D.preprocessing_output_path / D.feather_path
    train_lo, train_hi = cfg.train_years
    val_lo, val_hi = cfg.val_years
    test_lo, test_hi = cfg.test_years
    columns = [D.file_path, D.filename, D.variable, D.year, D.month, D.resolution, D.stage]
    for var in WC.temperature_vars + [WC.elev]:
        files = glob(os.path.join(wc_extent_dir, "**", f"*{var}*.tif"), recursive=True)
        records = []
        for fp in files:
            filename = os.path.basename(fp)
            year = _year_from_filename(filename)
            month = _month_from_filename(filename)
            resolution = _resolution_from_filename(filename)
            if (train_lo <= year <= train_hi) or _is_future(year):
                stage = consts.stages.train
            elif val_lo <= year <= val_hi:
                stage = consts.stages.val
            elif test_lo <= year <= test_hi:
                stage = consts.stages.test
            elif var == WC.elev:
                stage = var
            else:
                stage = ""
            records.append((fp, filename, var, year, month, resolution, stage))
        out_dir = feather_base / var
        out_dir.mkdir(parents=True, exist_ok=True)
        for stage in dict.fromkeys(r[-1] for r in records):  # pandas' unique(): first-seen order
            if stage == "":
                continue
            name = f"{stage}_europe_extent.feather" if stage != WC.elev else f"{WC.elev}_europe_extent.feather"
            _write_table([r for r in records if r[-1] == stage], columns, out_dir / name)
