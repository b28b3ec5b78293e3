# -*- coding: utf-8 -*-
"""DataModule: index loading/merging and per-stage dataset construction. The
port of ``climsr_tpu.data.datamodule``.

Parity: ``climsr/data/super_resolution_data_module.py`` —

- requires the 2.5m resolution (``:25``),
- europe-extent filename suffixing (``:67-72``),
- ``use_extra_data`` filter (year <= 2020) + resolution filter (``:84-88``),
- "temp" variable = concat of tmin/tavg/tmax train+val with per-variable test
  sets (``:104-114``),
- inner-join of tile tables with the min-max stats table on
  (filename, variable, year, month, resolution) (``:128-161``),
- ``model_data_kwargs`` surface for the task (``:174-195``).

The tables are :class:`~climsr_tpu_torch.data.tables.Table` s. They are read
from the feather files under ``data_path`` with ``read_feather`` (which needs
pandas), unless the caller passes ``tables``: a dict keyed by the path under
``pre-processed/feather/`` (``"tmin/train.feather"``, ...), as
``make_synthetic_dataset`` returns it. Either way the same code runs.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.schemas import SuperResolutionDataConfig
from climsr_tpu_torch.data import normalization
from climsr_tpu_torch.data.climate_dataset import ClimateDataset
from climsr_tpu_torch.data.tables import Table, read_feather

D = consts.datasets_and_preprocessing
logger = logging.getLogger(__name__)


class SuperResolutionDataModule:
    def __init__(self, cfg: SuperResolutionDataConfig, tables: Optional[Dict[str, Table]] = None):
        assert consts.world_clim.resolution_2_5m in cfg.resolutions, "2.5m resolution is required!"
        self.cfg = cfg
        self.tables = tables
        self.ds: Dict[str, object] = {}
        self._setup()

    # -- index loading -----------------------------------------------------
    def _feather_dir(self) -> str:
        return os.path.join(
            os.path.abspath(self.cfg.data_path), D.preprocessing_output_path, D.feather_path
        )

    def _read(self, relpath: str) -> Table:
        if self.tables is not None:
            return self.tables[relpath]
        return read_feather(os.path.join(self._feather_dir(), relpath))

    def _load_dataframe(self, var: str, filename: str) -> Table:
        if self.cfg.europe_extent:
            stem, ext = os.path.splitext(filename)
            filename = f"{stem}_europe_extent{ext}"
        return self._read(f"{var}/{filename}")

    def _filter_df(self, df: Table) -> Table:
        if not self.cfg.use_extra_data:
            df = df.filter(df[D.year] <= 2020)
        return df.filter(df.isin(D.resolution, self.cfg.resolutions))

    def _load_data(self) -> Tuple[Table, Table, List[Table], Table, Table]:
        elevation_df = self._filter_df(
            self._load_dataframe(consts.world_clim.elev, f"{consts.world_clim.elev}.feather")
        )
        stats_df = self._filter_df(self._read(D.min_max_stats_filename))

        if self.cfg.world_clim_variable == consts.world_clim.temp:
            train_dfs, val_dfs, test_dfs = [], [], []
            for var in consts.world_clim.temperature_vars:
                train_dfs.append(self._filter_df(self._load_dataframe(var, D.train_feather)))
                val_dfs.append(self._filter_df(self._load_dataframe(var, D.val_feather)))
                test_dfs.append(self._filter_df(self._load_dataframe(var, D.test_feather)))
            train_df = Table.concat(train_dfs)
            val_df = Table.concat(val_dfs)
        else:
            train_df = self._filter_df(self._load_dataframe(self.cfg.world_clim_variable, D.train_feather))
            val_df = self._filter_df(self._load_dataframe(self.cfg.world_clim_variable, D.val_feather))
            test_dfs = [self._filter_df(self._load_dataframe(self.cfg.world_clim_variable, D.test_feather))]

        merge_columns = [D.filename, D.variable, D.year, D.month, D.resolution]
        if self.cfg.europe_extent and D.file_path in stats_df.columns:
            stats_df = stats_df.drop([D.file_path])

        train_df = train_df.merge(stats_df, on=merge_columns)
        val_df = val_df.merge(stats_df, on=merge_columns)
        test_dfs = [df.merge(stats_df, on=merge_columns) for df in test_dfs]

        zscore_df = self._read(D.zscore_stats_filename)
        return train_df, val_df, test_dfs, elevation_df, zscore_df

    # -- dataset construction ----------------------------------------------
    def _build_dataset(self, stage: str, df, elevation_df, zscore_df) -> ClimateDataset:
        return ClimateDataset(
            df=df,
            elevation_df=elevation_df,
            stage=stage,
            generator_type=self.cfg.generator_type,
            variable=self.cfg.world_clim_variable,
            scaling_factor=self.cfg.scale_factor,
            normalize=self.cfg.normalization_method == normalization.minmax,
            standardize=self.cfg.normalization_method == normalization.zscore,
            standardize_stats=zscore_df,
            normalize_range=tuple(self.cfg.normalization_range),
            use_elevation=self.cfg.use_elevation,
            use_mask=self.cfg.use_mask,
            use_global_min_max=self.cfg.use_global_min_max,
            europe_extent=self.cfg.europe_extent,
            transforms_cfg=self.cfg.transforms,
        )

    def _setup(self) -> None:
        train_df, val_df, test_dfs, elevation_df, zscore_df = self._load_data()
        logger.info(
            "'%s' - Train/Validation/Test split sizes (HR): %d/%d/%s",
            self.cfg.world_clim_variable,
            len(train_df),
            len(val_df),
            [len(df) for df in test_dfs],
        )
        self.ds[consts.stages.train] = self._build_dataset(consts.stages.train, train_df, elevation_df, zscore_df)
        self.ds[consts.stages.val] = self._build_dataset(consts.stages.val, val_df, elevation_df, zscore_df)
        self.ds[consts.stages.test] = [
            self._build_dataset(consts.stages.test, df, elevation_df, zscore_df) for df in test_dfs
        ]
        self.zscore_df = zscore_df

    def zscore_stats(self, world_clim_variable: str) -> Tuple[float, float]:
        """(mean, std) of the z-score table's row for ``world_clim_variable``."""
        key = D.world_clim_to_cruts_mapping[world_clim_variable]
        return (float(self.zscore_df.lookup(D.variable, key, consts.stats.mean)),
                float(self.zscore_df.lookup(D.variable, key, consts.stats.std)))

    @property
    def train_dataset(self) -> ClimateDataset:
        return self.ds[consts.stages.train]

    @property
    def val_dataset(self) -> ClimateDataset:
        return self.ds[consts.stages.val]

    @property
    def test_datasets(self) -> List[ClimateDataset]:
        return self.ds[consts.stages.test]

    @property
    def model_data_kwargs(self) -> Dict:
        return {
            "data_path": os.path.abspath(self.cfg.data_path),
            "world_clim_variable": self.cfg.world_clim_variable,
            "normalization_method": self.cfg.normalization_method,
            "normalization_range": tuple(self.cfg.normalization_range),
            "generator_type": self.cfg.generator_type,
            "batch_size": self.cfg.batch_size,
            "use_elevation": self.cfg.use_elevation,
            "use_mask": self.cfg.use_mask,
            "use_global_min_max": self.cfg.use_global_min_max,
            "use_extra_data": self.cfg.use_extra_data,
            "resolutions": self.cfg.resolutions,
            "transforms": self.cfg.transforms,
            "seed": self.cfg.seed,
        }
