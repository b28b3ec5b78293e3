# -*- coding: utf-8 -*-
"""Point-wise comparison of SR NetCDF vs CRU-TS NetCDF at probe locations:
the port of ``climsr_tpu.result_inspection.models``.

Parity: reference ``climsr/result_inspection/models.py`` — ``StatsResult`` /
``CompareStatsResults.compute`` extract nearest-neighbor time series at probe
lat/lons from both datasets and report quantiles, min/max/mean/median plus
MAE/MSE/RMSE; line/box plots and a summary table. The summary is a
:class:`~climsr_tpu_torch.data.tables.Table` (pandas' frame in the JAX
package), written by :func:`write_csv` as pandas' ``to_csv(index=False)``
writes it; matplotlib is imported inside the plots.
"""
from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from climsr_tpu_torch.data.tables import Table
from climsr_tpu_torch.io.netcdf import ClimateSeries

QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclasses.dataclass
class StatsResult:
    name: str
    lat: float
    lon: float
    alt: Optional[float]
    mean: float
    median: float
    min: float
    max: float
    quantiles: dict


@dataclasses.dataclass
class CompareStatsResults:
    """Comparison of SR ('nn') vs original CRU-TS series at probe points."""

    nn_results: List[StatsResult]
    cru_results: List[StatsResult]
    mae: float
    mse: float
    rmse: float

    @classmethod
    def compute(
        cls,
        ds_nn: ClimateSeries,
        ds_cru: ClimateSeries,
        lats: Sequence[float],
        lons: Sequence[float],
        alts: Optional[Sequence[float]] = None,
        names: Optional[Sequence[str]] = None,
    ) -> "CompareStatsResults":
        alts = alts if alts is not None else [None] * len(lats)
        names = names if names is not None else [f"p{i}" for i in range(len(lats))]

        def extract(ds: ClimateSeries, lat, lon) -> np.ndarray:
            i = int(np.abs(ds.lat - lat).argmin())
            j = int(np.abs(ds.lon - lon).argmin())
            return ds.data[:, i, j]

        nn_results, cru_results = [], []
        nn_all, cru_all = [], []
        for name, lat, lon, alt in zip(names, lats, lons, alts):
            for ds, results, acc in ((ds_nn, nn_results, nn_all), (ds_cru, cru_results, cru_all)):
                series = extract(ds, lat, lon)
                valid = series[np.isfinite(series)]
                acc.append(series)
                results.append(
                    StatsResult(
                        name=name,
                        lat=lat,
                        lon=lon,
                        alt=alt,
                        mean=float(np.nanmean(series)),
                        median=float(np.nanmedian(series)),
                        min=float(np.nanmin(series)) if valid.size else float("nan"),
                        max=float(np.nanmax(series)) if valid.size else float("nan"),
                        quantiles={q: float(np.nanquantile(series, q)) for q in QUANTILES},
                    )
                )

        nn_stack = np.stack(nn_all)
        cru_stack = np.stack(cru_all)
        # align time axes if lengths differ (SR subset vs full series)
        t = min(nn_stack.shape[1], cru_stack.shape[1])
        diff = nn_stack[:, :t] - cru_stack[:, :t]
        finite = np.isfinite(diff)
        mae = float(np.abs(diff[finite]).mean())
        mse = float(np.square(diff[finite]).mean())
        return cls(nn_results=nn_results, cru_results=cru_results, mae=mae, mse=mse, rmse=float(np.sqrt(mse)))

    def to_frame(self) -> Table:
        rows = []
        for nn, cru in zip(self.nn_results, self.cru_results):
            rows.append(
                {
                    "name": nn.name,
                    "lat": nn.lat,
                    "lon": nn.lon,
                    "alt": nn.alt,
                    "nn_mean": nn.mean,
                    "cru_mean": cru.mean,
                    "nn_median": nn.median,
                    "cru_median": cru.median,
                    "nn_min": nn.min,
                    "cru_min": cru.min,
                    "nn_max": nn.max,
                    "cru_max": cru.max,
                }
            )
        return Table.from_rows(rows)

    def line_plot(self, save_path: Optional[Path] = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot([r.mean for r in self.nn_results], label="SR (nn)")
        ax.plot([r.mean for r in self.cru_results], label="CRU-TS")
        ax.set_xlabel("probe point")
        ax.set_ylabel("mean value")
        ax.legend()
        if save_path:
            fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return fig

    def box_plot(self, save_path: Optional[Path] = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        # label via set_xticklabels: boxplot's label kwarg was renamed
        # labels -> tick_labels in matplotlib 3.9, so neither spelling
        # works across the versions the unpinned viz extra allows
        ax.boxplot([[r.mean for r in self.nn_results], [r.mean for r in self.cru_results]])
        ax.set_xticklabels(["SR (nn)", "CRU-TS"])
        if save_path:
            fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return fig

    def print_comparison_summary(self) -> str:
        out = f"MAE={self.mae:.5f} MSE={self.mse:.5f} RMSE={self.rmse:.5f}"
        print(out)
        return out


def write_csv(table: Table, path) -> None:
    """``table`` as pandas' ``to_csv(index=False)`` writes a frame: a header,
    None and NaN as empty fields, floats as their ``repr``."""
    def cell(v):
        if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
            return ""
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return v.item() if isinstance(v, np.generic) else v

    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(table.columns)
        for row in table.rows():
            writer.writerow([cell(v) for v in row.values()])
