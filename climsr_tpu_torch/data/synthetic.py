# -*- coding: utf-8 -*-
"""Synthetic mini-dataset factory in the reference's on-disk layout: the port
of ``climsr_tpu.data.synthetic``.

From the same seed it writes the same GeoTIFF tiles as the JAX factory,
bitwise (through the port's own ``io/geotiff.py``), and builds the same index
and statistics tables, which it returns as :class:`~climsr_tpu_torch.data.tables.Table`
s keyed by their path under ``pre-processed/feather/`` (what
``SuperResolutionDataModule(cfg, tables=...)`` takes):

    {tmin,tavg,tmax,prec}/{train,val,test}.feather
    elev/elev.feather
    statistics_zscore.feather
    statistics_min_max.feather

With ``write_index=True`` (the default, as in the JAX package) it also writes
them as feather files (``io/feather.py``); ``write_index=False`` writes only
the tiles. Fields are smooth random
climate-like rasters (superposed cosines + terrain-correlated signal) so SR
models have learnable structure.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.tables import Table, write_feather
from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff

D = consts.datasets_and_preprocessing
S = consts.stats


def _smooth_field(rng: np.random.Generator, size: int, n_modes: int = 6, scale: float = 1.0) -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    field = np.zeros((size, size), np.float32)
    for _ in range(n_modes):
        fx, fy = rng.uniform(0.5, 4.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        field += rng.uniform(0.3, 1.0) * np.cos(2 * np.pi * (fx * xx + phase[0])) * np.cos(
            2 * np.pi * (fy * yy + phase[1])
        )
    return (field * scale).astype(np.float32)


def make_synthetic_dataset(
    root: os.PathLike,
    n_tiles_per_stage: Tuple[int, int, int] = (24, 8, 8),
    tile_size: int = 128,
    variables: Optional[List[str]] = None,
    europe_extent: bool = False,
    seed: int = 0,
    write_index: bool = True,
) -> Dict[str, Table]:
    """Create the tiles under ``root`` (the ``data_path`` config value); return
    the tables keyed by their path under ``pre-processed/feather/``, and with
    ``write_index`` write them there as feather files."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    feather_dir = root / D.preprocessing_output_path / D.feather_path
    tiles_dir = root / "tiles"
    tiles_dir.mkdir(parents=True, exist_ok=True)

    variables = variables or list(consts.world_clim.temperature_vars)
    hr_size = 452 if europe_extent else tile_size
    resolution = consts.world_clim.resolution_2_5m

    # shared terrain + ocean mask per tile grid position
    n_positions = max(n_tiles_per_stage)
    terrains = {}
    oceans = {}
    for pos in range(n_positions):
        terrains[pos] = _smooth_field(rng, hr_size, scale=800.0) + 600.0
        ocean = _smooth_field(rng, hr_size) < -0.8  # ~20% ocean blobs
        oceans[pos] = ocean

    # elevation tiles + index
    elev_rows = []
    elev_dir = tiles_dir / consts.world_clim.elev
    for pos in range(n_positions):
        x, y = pos * tile_size, 0
        fname = f"elev_{resolution}_{x}_{y}.tif"
        fp = elev_dir / fname
        elev_arr = terrains[pos].copy()
        elev_arr[oceans[pos]] = consts.world_clim.elevation_missing_indicator
        write_geotiff(fp, elev_arr, GeoProfile.global_grid(hr_size, hr_size, nodata=None))
        elev_rows.append(
            {
                D.filename: fname,
                D.file_path: str(fp),
                D.tile_file_path: str(fp),
                D.variable: consts.world_clim.elev,
                D.x: x,
                D.y: y,
                D.year: 0,
                D.month: 0,
                D.resolution: resolution,
            }
        )
    tables: Dict[str, Table] = {}
    # The datamodule suffixes *every* feather it loads in europe-extent mode
    # (reference super_resolution_data_module.py:67-72), including elev.
    elev_feather_name = (
        f"{consts.world_clim.elev}_europe_extent.feather" if europe_extent else f"{consts.world_clim.elev}.feather"
    )
    tables[f"{consts.world_clim.elev}/{elev_feather_name}"] = Table.from_rows(elev_rows)

    offsets = {consts.world_clim.tmin: -8.0, consts.world_clim.tavg: 0.0, consts.world_clim.tmax: 8.0,
               consts.world_clim.prec: 50.0}
    stage_years = {consts.stages.train: 1990, consts.stages.val: 2002, consts.stages.test: 2010}

    all_stats_rows = []
    zscore_rows: Dict[str, Dict[str, float]] = {}
    global_minmax: Dict[str, Tuple[float, float]] = {}

    per_var_tiles: Dict[str, Dict[str, List[dict]]] = {}
    for var in variables:
        per_var_tiles[var] = {}
        var_tile_dir = tiles_dir / var
        collected = []
        for stage, n_tiles in zip(consts.stages.stages, n_tiles_per_stage):
            rows = []
            year = stage_years[stage]
            for i in range(n_tiles):
                pos = i % n_positions
                month = (i % 12) + 1
                base = offsets.get(var, 0.0)
                arr = (
                    base
                    + _smooth_field(rng, hr_size, scale=10.0)
                    + 0.006 * (1500.0 - terrains[pos])  # lapse-rate-ish terrain coupling
                    + rng.normal(0, 0.3, (hr_size, hr_size)).astype(np.float32)
                ).astype(np.float32)
                arr[oceans[pos]] = np.nan
                x, y = pos * tile_size, 0
                fname = f"{var}_{year}_{month:02d}_{resolution}_{x}_{y}.tif"
                fp = var_tile_dir / fname
                write_geotiff(fp, arr, GeoProfile.global_grid(hr_size, hr_size))
                tile_min = float(np.nanmin(arr))
                tile_max = float(np.nanmax(arr))
                collected.append(arr)
                row = {
                    D.filename: fname,
                    D.file_path: str(fp),
                    D.tile_file_path: str(fp),
                    D.variable: var,
                    D.x: x,
                    D.y: y,
                    D.year: year + (i // 12),
                    D.month: month,
                    D.resolution: resolution,
                }
                rows.append(row)
                all_stats_rows.append(
                    {
                        D.filename: fname,
                        D.variable: var,
                        D.year: row[D.year],
                        D.month: month,
                        D.resolution: resolution,
                        D.dataset: "world-clim",
                        S.min: tile_min,
                        S.max: tile_max,
                    }
                )
            per_var_tiles[var][stage] = rows

        stacked = np.concatenate([a[np.isfinite(a)] for a in collected])
        gmin, gmax = float(stacked.min()), float(stacked.max())
        global_minmax[var] = (gmin, gmax)
        mean, std = float(stacked.mean()), float(stacked.std())
        cruts_name = D.world_clim_to_cruts_mapping.get(var, var)
        zscore_rows[cruts_name] = {
            S.mean: mean,
            S.std: std,
            S.min: gmin,
            S.max: gmax,
            S.normalized_min: (gmin - mean) / (std + 1e-8),
            S.normalized_max: (gmax - mean) / (std + 1e-8),
        }

    # 'temp' z-score = mean over tmin/tavg/tmax (reference preprocessing.py:250-361)
    tvars = [v for v in variables if v in consts.world_clim.temperature_vars]
    if tvars:
        agg = {k: float(np.mean([zscore_rows[D.world_clim_to_cruts_mapping.get(v, v)][k] for v in tvars]))
               for k in [S.mean, S.std, S.min, S.max, S.normalized_min, S.normalized_max]}
        zscore_rows[consts.cruts.tmp] = agg  # 'temp' maps to 'tmp'

    elev_vals = np.concatenate([t[~oceans[p]] for p, t in terrains.items()])
    zscore_rows[consts.world_clim.elev] = {
        S.mean: float(elev_vals.mean()),
        S.std: float(elev_vals.std()),
        S.min: float(elev_vals.min()),
        S.max: float(elev_vals.max()),
        S.normalized_min: float((elev_vals.min() - elev_vals.mean()) / (elev_vals.std() + 1e-8)),
        S.normalized_max: float((elev_vals.max() - elev_vals.mean()) / (elev_vals.std() + 1e-8)),
    }

    tables[D.zscore_stats_filename] = Table.from_rows([{D.variable: k, **v} for k, v in zscore_rows.items()])

    stats = Table.from_rows(all_stats_rows)
    for col, pick in ((S.global_min, 0), (S.global_max, 1)):
        values = np.full(len(stats), np.nan)
        for var, bounds in global_minmax.items():
            values[stats[D.variable] == var] = bounds[pick]
        stats = stats.with_column(col, values)
    tables[D.min_max_stats_filename] = stats

    for var in variables:
        for stage, fname in zip(
            consts.stages.stages, [D.train_feather, D.val_feather, D.test_feather]
        ):
            suffix = "_europe_extent" if europe_extent else ""
            if suffix:
                stem, ext = os.path.splitext(fname)
                fname_out = f"{stem}{suffix}{ext}"
            else:
                fname_out = fname
            tables[f"{var}/{fname_out}"] = Table.from_rows(per_var_tiles[var][stage])

    if write_index:
        for rel, table in tables.items():
            (feather_dir / rel).parent.mkdir(parents=True, exist_ok=True)
            write_feather(table, feather_dir / rel)
    return tables
