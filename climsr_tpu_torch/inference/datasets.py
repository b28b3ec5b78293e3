# -*- coding: utf-8 -*-
"""Inference datasets: whole CRU-TS NetCDF series and europe-extent GeoTIFF dirs.

Parity: reference ``climsr/data/sr/cruts_inference_dataset.py`` and
``geo_tiff_inference_dataset.py``:

- CRU-TS: per-month frame from the NetCDF, flipud (lat order), per-frame
  nanmin/nanmax min-max normalization, elevation channel from file with the
  land mask applied (Antarctica masking), srcnn nearest pre-upscale,
  ``cruts-{var}-{date}.tif`` output names,
- GeoTIFF: per-file LR frames (europe extent 113x113), min/max looked up in
  the stats table by filename, precomputed elevation/mask at HR and LR,
  same per-generator channel logic.

Host-side numpy; batches stack to NHWC for the device. The port of
``climsr_tpu.inference.datasets``: cv2's nearest resize is
:func:`climsr_tpu_torch.ops.resize.resize_nearest` (the same index rule), and
the stats tables are :class:`~climsr_tpu_torch.data.tables.Table` s (a pandas
DataFrame passed in is converted where it enters), so this module imports
neither cv2 nor pandas.
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.normalization import MinMaxScaler, StandardScaler
from climsr_tpu_torch.data.tables import as_table
from climsr_tpu_torch.io.geotiff import read_raster
from climsr_tpu_torch.io.netcdf import read_climate_series
from climsr_tpu_torch.ops.resize import resize_nearest

B = consts.batch_items
S = consts.stats
D = consts.datasets_and_preprocessing


def _hwc(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.ascontiguousarray(arr, dtype=np.float32)


def get_variable_from_ds_fp(path: str) -> str:
    """Extract the CRU-TS variable name from the dataset filename."""
    name = os.path.basename(path)
    for var in consts.cruts.variables_cts:
        if f".{var}." in name:
            return var
    raise ValueError(f"Cannot infer CRU-TS variable from {name}")


class CRUTSInferenceDataset:
    def __init__(
        self,
        ds_path: str,
        elevation_file: str,
        land_mask_file: str,
        generator_type: str,
        scaling_factor: int = 4,
        normalize: bool = True,
        standardize: bool = False,
        standardize_stats: Optional[Any] = None,  # Table or pandas DataFrame
        normalize_range: Tuple[float, float] = (-1.0, 1.0),
        use_elevation: bool = True,
        use_mask: bool = True,
    ):
        self.variable = get_variable_from_ds_fp(ds_path)
        self.series = read_climate_series(ds_path, self.variable)
        self.generator_type = generator_type
        self.scaling_factor = scaling_factor
        self.normalize = normalize
        self.standardize = standardize
        self.use_elevation = use_elevation
        self.use_mask = use_mask
        self.land_mask_file = land_mask_file

        if standardize:
            stats = as_table(standardize_stats)

            def at(key, column):
                return float(stats.lookup(D.variable, key, column))

            elev = consts.cruts.elev if consts.cruts.elev in set(stats[D.variable]) else consts.world_clim.elev
            self.scaler = StandardScaler(mean=at(self.variable, S.mean), std=at(self.variable, S.std))
            self.elevation_scaler = StandardScaler(mean=at(elev, S.mean), std=at(elev, S.std))
        else:
            self.scaler = MinMaxScaler(feature_range=normalize_range)
            self.elevation_scaler = MinMaxScaler(feature_range=normalize_range)

        self.land_mask = read_raster(land_mask_file).astype(np.float32)
        self.mask_np = ~np.isnan(self.land_mask)
        elevation_arr = read_raster(elevation_file).astype(np.float32)
        elevation_arr = np.where(self.mask_np, elevation_arr, np.nan)  # mask Antarctica
        # SRTM void pixels (-32768) are missing data, not values: without the
        # indicator the minmax auto-range collapses (vmin=-32768) and z-score
        # feeds ~-100-sigma outliers to the convs (same fix as the GeoTIFF
        # dataset below).
        elevation_arr = self.elevation_scaler.normalize(
            elevation_arr, missing_indicator=consts.world_clim.elevation_missing_indicator
        )
        # ocean NaNs must not reach the convs (one NaN floods the output);
        # minmax substitutes inside the scaler, z-score leaves them (reference
        # quirk: a 0.0 nan_substitution is a no-op) — substitute here
        self.elevation_data = _hwc(np.nan_to_num(elevation_arr, nan=0.0))
        self.mask_hr = _hwc(self.mask_np.astype(np.float32))
        # LR grid from the actual series (360x720 for real CRU-TS)
        h, w = self.series.data.shape[1:]
        self.hr_shape = (h * scaling_factor, w * scaling_factor)
        # LR-resolution conditioning channels. The reference's NetCDF dataset
        # returns a bare 1-channel frame (cruts_inference_dataset.py:94-107),
        # which shape-mismatches any generator trained with elevation/mask
        # input channels — we assemble them like the GeoTIFF path does.
        self.elevation_lr = _hwc(
            resize_nearest(self.elevation_data[..., 0], h, w)
        )
        self.mask_lr = _hwc(
            resize_nearest(self.mask_np.astype(np.float32), h, w)
        )

    def __len__(self) -> int:
        return self.series.data.shape[0]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        arr = self.series.data[index]
        input_img = np.flipud(arr.astype(np.float32)).copy()

        vmin = float(np.nanmin(input_img))
        vmax = float(np.nanmax(input_img))
        # minmax mode: auto-range normalize (per-image nanmin/nanmax, the
        # reference's per-frame behavior); standardize mode: z-score.
        # NaN ocean pixels are substituted either way (see __init__ note).
        input_img = np.nan_to_num(self.scaler.normalize(input_img), nan=0.0)

        if self.generator_type == consts.models.srcnn:
            h, w = input_img.shape
            input_img = resize_nearest(input_img, h * self.scaling_factor, w * self.scaling_factor)
            img_lr = _hwc(input_img)
            if self.use_elevation:
                img_lr = np.concatenate([img_lr, self.elevation_data], axis=-1)
            if self.use_mask:
                img_lr = np.concatenate([img_lr, self.mask_hr], axis=-1)
        else:
            img_lr = _hwc(input_img)
            if self.use_elevation:
                img_lr = np.concatenate([img_lr, self.elevation_lr], axis=-1)
            if self.use_mask:
                img_lr = np.concatenate([img_lr, self.mask_lr], axis=-1)

        date_str = np.datetime_as_string(self.series.time[index], unit="D")
        return {
            B.lr: img_lr,
            B.elevation: self.elevation_data,
            B.mask: self.mask_hr,
            B.min: np.float32(vmin),
            B.max: np.float32(vmax),
            B.filename: f"cruts-{self.variable}-{date_str}.tif",
        }


class GeoTiffInferenceDataset:
    def __init__(
        self,
        tiff_dir: str,
        tiff_df: Any,  # Table or pandas DataFrame
        elevation_file: str,
        land_mask_file: str,
        generator_type: str,
        variable: str,
        hr_size: int = 452,
        scaling_factor: int = 4,
        normalize: bool = True,
        standardize: bool = False,
        standardize_stats: Optional[Any] = None,  # Table or pandas DataFrame
        normalize_range: Tuple[float, float] = (-1.0, 1.0),
        use_elevation: bool = True,
        use_mask: bool = True,
        use_global_min_max: bool = True,
    ):
        self.tiffs = sorted(glob(f"{tiff_dir}/*.tif"))
        self.tiff_df = as_table(tiff_df)
        self.generator_type = generator_type
        self.variable = variable
        self.hr_size = hr_size
        self.lr_size = hr_size // scaling_factor
        self.scaling_factor = scaling_factor
        self.normalize = normalize
        self.standardize = standardize
        self.use_elevation = use_elevation
        self.use_mask = use_mask
        self.use_global_min_max = use_global_min_max
        self.land_mask_file = land_mask_file

        if standardize:
            stats = as_table(standardize_stats)

            def at(key, column):
                return float(stats.lookup(D.variable, key, column))

            key = D.world_clim_to_cruts_mapping.get(variable, variable)
            self.scaler = StandardScaler(mean=at(key, S.mean), std=at(key, S.std))
            self.elevation_scaler = StandardScaler(
                mean=at(consts.world_clim.elev, S.mean), std=at(consts.world_clim.elev, S.std)
            )
        else:
            self.scaler = MinMaxScaler(feature_range=normalize_range)
            self.elevation_scaler = MinMaxScaler(feature_range=normalize_range)

        land = read_raster(land_mask_file).astype(np.float32)
        self.mask_np = ~np.isnan(land)
        self.mask_hr = _hwc(self.mask_np.astype(np.float32))
        self.mask_lr = _hwc(
            resize_nearest(self.mask_np.astype(np.float32), self.lr_size, self.lr_size)
        )

        elevation_arr = read_raster(elevation_file).astype(np.float32)
        elevation_arr = np.where(self.mask_np, elevation_arr, np.nan)
        # both modes: SRTM void pixels (-32768) are missing data, not values —
        # without this the z-score path would feed ~-100-sigma outliers to the
        # convs (the reference crashes outright here in standardize mode; see
        # StandardScaler._normalize)
        elevation_arr = self.elevation_scaler.normalize(
            elevation_arr, missing_indicator=consts.world_clim.elevation_missing_indicator
        )
        # NaNs (ocean/Antarctica) must not reach the convs; z-score leaves
        # them in place (0.0 nan_substitution is a reference-quirk no-op)
        elevation_arr = np.nan_to_num(elevation_arr, nan=0.0)
        self.elevation_data = _hwc(elevation_arr)
        self.elevation_lr = _hwc(
            resize_nearest(elevation_arr, self.lr_size, self.lr_size)
        )

    def __len__(self) -> int:
        return len(self.tiffs)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        file_path = self.tiffs[index]
        file_name = os.path.basename(file_path)
        col = (S.global_min, S.global_max) if self.use_global_min_max else (S.min, S.max)
        vmin = float(self.tiff_df.lookup(D.filename, file_name, col[0]))
        vmax = float(self.tiff_df.lookup(D.filename, file_name, col[1]))

        original = np.flipud(read_raster(file_path).astype(np.float32)).copy()
        img_lr = original.copy()
        if self.normalize:
            img_lr = self.scaler.normalize(img_lr, vmin, vmax)
        else:
            img_lr = np.nan_to_num(self.scaler.normalize(img_lr), nan=0.0)

        if self.generator_type == consts.models.srcnn:
            img_lr = resize_nearest(img_lr, self.hr_size, self.hr_size)
            lr_input = _hwc(img_lr)
            if self.use_elevation:
                lr_input = np.concatenate([lr_input, self.elevation_data], axis=-1)
            if self.use_mask:
                lr_input = np.concatenate([lr_input, self.mask_hr], axis=-1)
        else:
            lr_input = _hwc(img_lr)
            if self.use_elevation:
                lr_input = np.concatenate([lr_input, self.elevation_lr], axis=-1)
            if self.use_mask:
                lr_input = np.concatenate([lr_input, self.mask_lr], axis=-1)

        return {
            B.lr: lr_input,
            B.elevation: self.elevation_data,
            B.mask: self.mask_hr,
            B.min: np.float32(vmin),
            B.max: np.float32(vmax),
            B.filename: file_name,
        }
