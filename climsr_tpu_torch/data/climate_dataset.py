# -*- coding: utf-8 -*-
"""Host-side train/val/test tile dataset (numpy), reference-parity sample
assembly: the port of ``climsr_tpu.data.climate_dataset``.

Parity: ``climsr/data/sr/climate_dataset.py`` —

- tile read (float32 GeoTIFF, NaN ocean) + elevation lookup by (x, y, resolution)
  or by resolution for europe extent (``:237-249``),
- min-max (per-tile or global min/max from the stats join) or z-score
  normalization; **elevation min-max normalizes per-tile with auto min/max**
  (reference quirk, ``:259-262``),
- land mask from the *original* (pre-normalization) raster, ``~isnan`` (``:270``),
- train: v/h-flip + random 90° rotations, LR = INTER_NEAREST decimation of the
  *normalized* HR (``:144-189``), drawn from ``np.random.default_rng((epoch_key,
  index))`` as in the JAX package, so the samples are the JAX package's bit for bit,
- channel assembly (``_concat_if_needed:94-120``): srcnn gets the
  nearest-upscaled LR at HR size with HR elev/mask channels; other models get
  the true LR with LR elev (nearest-resized) and LR mask channels,
- val/test adds cubic baseline, original data, per-tile min/max (``:191-218``).

cv2's resizes are the port's numpy ones (``ops/resize.py``): ``resize_nearest``
with cv2's index rule, and ``resize_cubic`` for ``INTER_CUBIC``. The index and
statistics tables are :class:`~climsr_tpu_torch.data.tables.Table` s (a pandas
DataFrame is converted where it enters). Arrays are HWC float32; the collate
step stacks them to NHWC and the device transfer views them as NCHW.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.schemas import TransformsCfg
from climsr_tpu_torch.data.normalization import MinMaxScaler, StandardScaler
from climsr_tpu_torch.data.tables import as_table
from climsr_tpu_torch.io.geotiff import read_raster
from climsr_tpu_torch.ops.resize import resize_cubic, resize_nearest

D = consts.datasets_and_preprocessing
B = consts.batch_items
S = consts.stats


def _hwc(arr: np.ndarray) -> np.ndarray:
    """HW -> HWC float32 (channel-last; the reference's ToTensor makes CHW)."""
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.ascontiguousarray(arr, dtype=np.float32)


class ClimateDataset:
    def __init__(
        self,
        df: Any,
        elevation_df: Any,
        generator_type: str,
        variable: str,
        stage: str = consts.stages.train,
        scaling_factor: int = 4,
        normalize: bool = True,
        standardize: bool = False,
        standardize_stats: Optional[Any] = None,
        normalize_range: Tuple[float, float] = (-1.0, 1.0),
        use_elevation: bool = True,
        use_mask: bool = True,
        use_global_min_max: bool = True,
        europe_extent: bool = False,
        transforms_cfg: Optional[TransformsCfg] = None,
        cache_tiles: bool = True,
    ):
        if normalize == standardize:
            raise ValueError("Bad parameter combination: normalization and standardization! Choose one!")
        self.df = as_table(df)
        self.elevation_df = elevation_df = as_table(elevation_df)
        self.generator_type = generator_type
        self.variable = variable
        self.stage = stage
        self.scaling_factor = scaling_factor
        self.normalize = normalize
        self.standardize = standardize
        self.normalize_range = tuple(normalize_range)
        self.use_elevation = use_elevation
        self.use_mask = use_mask
        self.use_global_min_max = use_global_min_max
        self.europe_extent = europe_extent
        self.hr_size = 452 if europe_extent else 128
        self.lr_size = self.hr_size // scaling_factor
        self.transforms_cfg = transforms_cfg or TransformsCfg()

        if standardize:
            stats = as_table(standardize_stats)

            def at(key, column):
                return float(stats.lookup(D.variable, key, column))

            cruts_var = D.world_clim_to_cruts_mapping[variable]
            self.scaler = StandardScaler(
                mean=at(cruts_var, S.mean),
                std=at(cruts_var, S.std),
                nan_substitution=at(cruts_var, S.normalized_min),
            )
            self.elevation_scaler = StandardScaler(
                mean=at(consts.world_clim.elev, S.mean),
                std=at(consts.world_clim.elev, S.std),
                missing_indicator=consts.world_clim.elevation_missing_indicator,
                nan_substitution=at(consts.world_clim.elev, S.normalized_min),
            )
        else:
            self.scaler = MinMaxScaler(feature_range=self.normalize_range)
            self.elevation_scaler = MinMaxScaler(feature_range=self.normalize_range)

        # pre-resolve elevation tile path per (x, y, resolution) for O(1) lookup
        fp_col = D.file_path if europe_extent else D.tile_file_path
        self._fp_col = fp_col
        if europe_extent:
            self._elev_lookup = {
                row[D.resolution]: row[fp_col] for row in elevation_df.rows()
            }
        else:
            self._elev_lookup = {
                (row[D.x], row[D.y], row[D.resolution]): row[fp_col] for row in elevation_df.rows()
            }
        self._elev_cache: Dict[str, np.ndarray] = {}
        # In-RAM cache of decoded+normalized tiles (~80-150 KB per 128x128
        # tile: ~2.5 GB for a 30k-tile real dataset). Decoding and
        # normalization happen once; per-epoch work reduces to augmentation +
        # resize + stacking (the reference re-reads and re-normalizes every
        # tile every epoch).
        self.cache_tiles = cache_tiles
        self._tile_cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = {}
        # per-sample augmentation RNG state: derived from (seed-key, index),
        # so results are independent of the decode thread pool's scheduling
        # (the global `random` module would make seeded runs irreproducible).
        # The loader passes seed+epoch as the key (pipeline.DataLoader.set_epoch).
        self._epoch = 0

    def set_epoch(self, epoch_key: int) -> None:
        self._epoch = int(epoch_key)

    def __len__(self) -> int:
        return len(self.df)

    # -- resize helpers with reference cv2 semantics
    def _to_lr(self, img: np.ndarray) -> np.ndarray:
        return resize_nearest(img, self.lr_size, self.lr_size)

    def _to_hr_nearest(self, img: np.ndarray) -> np.ndarray:
        return resize_nearest(img, self.hr_size, self.hr_size)

    def _to_hr_cubic(self, img: np.ndarray) -> np.ndarray:
        return resize_cubic(img, self.hr_size, self.hr_size)

    def _read_elevation(self, row: Dict[str, Any]) -> np.ndarray:
        key = row[D.resolution] if self.europe_extent else (row[D.x], row[D.y], row[D.resolution])
        fp = self._elev_lookup[key]
        if fp not in self._elev_cache:
            self._elev_cache[fp] = read_raster(fp).astype(np.float32)
        return self._elev_cache[fp].copy()

    def _concat_channels(
        self,
        img_lr: np.ndarray,
        img_sr_nearest: np.ndarray,
        img_elev: np.ndarray,
        img_elev_lr: np.ndarray,
        mask_hr: np.ndarray,
        mask_np: np.ndarray,
    ) -> np.ndarray:
        if self.generator_type == consts.models.srcnn:
            out = img_sr_nearest
            if self.use_elevation:
                out = np.concatenate([out, img_elev], axis=-1)
            if self.use_mask:
                out = np.concatenate([out, mask_hr], axis=-1)
            return out
        out = img_lr
        if self.use_elevation:
            out = np.concatenate([out, img_elev_lr], axis=-1)
        if self.use_mask:
            mask_lr = _hwc(self._to_lr(mask_np.astype(np.float32)))
            out = np.concatenate([out, mask_lr], axis=-1)
        return out

    def _load_normalized(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(normalized_hr, normalized_elev, mask, original) for a tile row."""
        if self.cache_tiles and index in self._tile_cache:
            return self._tile_cache[index]
        row = self.df.row(index)
        tile_min = float(row[S.global_min] if self.use_global_min_max else row[S.min])
        tile_max = float(row[S.global_max] if self.use_global_min_max else row[S.max])

        original_image = read_raster(row[self._fp_col]).astype(np.float32)
        img_hr = original_image.copy()
        img_elev = self._read_elevation(row)

        if self.normalize:
            img_hr = self.scaler.normalize(img_hr, tile_min, tile_max)
            img_elev = self.elevation_scaler.normalize(
                img_elev, missing_indicator=consts.world_clim.elevation_missing_indicator
            )
        else:
            img_hr = self.scaler.normalize(img_hr)
            img_elev = self.elevation_scaler.normalize(img_elev)

        mask = ~np.isnan(original_image)
        item = (img_hr, img_elev, mask, original_image)
        if self.cache_tiles:
            self._tile_cache[index] = item
        return item

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_hr, img_elev, mask, original_image = self._load_normalized(index)

        if self.stage == consts.stages.train:
            return self._training_sample(img_hr, img_elev, mask, index)
        # the per-tile stats row is only needed by the val/test sample
        row = self.df.row(index)
        tile_min = float(row[S.global_min] if self.use_global_min_max else row[S.min])
        tile_max = float(row[S.global_max] if self.use_global_min_max else row[S.max])
        return self._val_test_sample(img_hr, img_elev, mask, original_image, tile_min, tile_max)

    def _training_sample(self, img_hr, img_elev, mask, index: int) -> Dict[str, np.ndarray]:
        t = self.transforms_cfg
        rng = np.random.default_rng((self._epoch, index))
        if t.v_flip and rng.random() > 0.5:
            img_hr, img_elev, mask = np.flipud(img_hr), np.flipud(img_elev), np.flipud(mask)
        if t.h_flip and rng.random() > 0.5:
            img_hr, img_elev, mask = np.fliplr(img_hr), np.fliplr(img_elev), np.fliplr(mask)
        if t.random_90_rotation and rng.random() > 0.5:
            k = int(rng.integers(0, 4))
            img_hr, img_elev, mask = np.rot90(img_hr, k), np.rot90(img_elev, k), np.rot90(mask, k)
        img_hr = np.ascontiguousarray(img_hr)
        img_elev = np.ascontiguousarray(img_elev)
        mask = np.ascontiguousarray(mask)

        img_lr = self._to_lr(img_hr)
        img_sr_nearest = _hwc(self._to_hr_nearest(img_lr))
        img_elev_lr = _hwc(self._to_lr(img_elev))
        mask_hr = _hwc(mask.astype(np.float32))

        lr_input = self._concat_channels(_hwc(img_lr), img_sr_nearest, _hwc(img_elev), img_elev_lr, mask_hr, mask)
        return {
            B.lr: lr_input,
            B.hr: _hwc(img_hr),
            B.elevation: _hwc(img_elev),
            B.mask: mask_hr,
        }

    def _val_test_sample(self, img_hr, img_elev, mask, original_image, tile_min, tile_max) -> Dict[str, np.ndarray]:
        img_lr = self._to_lr(img_hr)
        img_sr_cubic = _hwc(self._to_hr_cubic(img_lr))
        img_sr_nearest = _hwc(self._to_hr_nearest(img_lr))
        img_elev_lr = _hwc(self._to_lr(img_elev))
        mask_hr = _hwc(mask.astype(np.float32))

        lr_input = self._concat_channels(_hwc(img_lr), img_sr_nearest, _hwc(img_elev), img_elev_lr, mask_hr, mask)
        return {
            B.lr: lr_input,
            B.hr: _hwc(img_hr),
            B.elevation: _hwc(img_elev),
            B.elevation_lr: img_elev_lr,
            B.nearest: img_sr_nearest,
            B.cubic: img_sr_cubic,
            B.original_data: _hwc(np.nan_to_num(original_image, nan=0.0)),
            B.mask: mask_hr,
            B.min: np.float32(tile_min),
            B.max: np.float32(tile_max),
        }
