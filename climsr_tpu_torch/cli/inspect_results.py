# -*- coding: utf-8 -*-
"""Result-inspection CLI: the port of ``climsr_tpu.cli.inspect_results``
(reference ``climsr/cli/inspect_results.py``): point-wise SR vs CRU-TS
comparison at mountain peaks.

Loads the SR NetCDF and the original CRU-TS NetCDF, runs three comparisons
(custom points file / built-in mountain peaks / 2-location subset), writes
line/box plots and a CSV for each. The plots need matplotlib, imported in
the call as in the JAX package; where it is not installed (the GPU machine
may lack it) the plots are skipped with a warning. The CSVs need nothing
beyond the standard library.

Usage: ``python -m climsr_tpu_torch.cli.inspect_results
result_inspection.ds_temp_nn_path=<sr.nc> result_inspection.ds_temp_cru_path=<cru.nc>``
"""
from __future__ import annotations

import importlib.util
import logging
import os
import sys
from pathlib import Path
from typing import List, Optional

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.compose import compose, default_config_dir
from climsr_tpu_torch.config.schemas import ResultInspectionConfig, from_dict
from climsr_tpu_torch.data.tables import read_feather
from climsr_tpu_torch.inference.datasets import get_variable_from_ds_fp
from climsr_tpu_torch.io.netcdf import read_climate_series
from climsr_tpu_torch.result_inspection.models import CompareStatsResults, write_csv

logger = logging.getLogger(__name__)


def plots_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _run_internal(ds_nn, ds_cru, lats, lons, alts, names, tag: str, results_dir: Path) -> CompareStatsResults:
    results = CompareStatsResults.compute(ds_nn, ds_cru, lats, lons, alts, names)
    results.print_comparison_summary()
    if plots_available():
        results.line_plot(results_dir / f"{tag}_line.png")
        results.box_plot(results_dir / f"{tag}_box.png")
    else:
        logger.warning("matplotlib is not installed: the %s plots are skipped", tag)
    write_csv(results.to_frame(), results_dir / f"{tag}.csv")
    logger.info("Wrote %s comparison to %s", tag, results_dir)
    return results


def run(cfg: ResultInspectionConfig) -> dict:
    """The three comparisons; returns each one's results by its tag."""
    results_dir = Path(cfg.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)

    var_nn = get_variable_from_ds_fp(cfg.ds_temp_nn_path)
    var_cru = get_variable_from_ds_fp(cfg.ds_temp_cru_path)
    ds_nn = read_climate_series(cfg.ds_temp_nn_path, var_nn)
    ds_cru = read_climate_series(cfg.ds_temp_cru_path, var_cru)

    ri = consts.result_inspection
    out = {}
    # 1) custom probe points from feather, if provided
    if cfg.peaks_feather and os.path.exists(cfg.peaks_feather):
        peaks = read_feather(cfg.peaks_feather)
        n = len(peaks)
        alt_col = next((c for c in ("altitude", "alt") if c in peaks.columns), None)
        alts = peaks[alt_col].tolist() if alt_col else [None] * n
        names = peaks["name"].tolist() if "name" in peaks.columns else [f"peak{i}" for i in range(n)]
        out["peaks_feather"] = _run_internal(ds_nn, ds_cru, peaks["lat"].tolist(), peaks["lon"].tolist(), alts,
                                             names, "peaks_feather", results_dir)
    # 2) built-in mountain-peak probe set
    out["mountain_peaks"] = _run_internal(ds_nn, ds_cru, ri.lats, ri.lons, ri.alts,
                                          [f"peak{i}" for i in range(len(ri.lats))], "mountain_peaks", results_dir)
    # 3) two-location subset
    out["2_locations"] = _run_internal(ds_nn, ds_cru, ri.lats[:2], ri.lons[:2], ri.alts[:2],
                                       ["loc0", "loc1"], "2_locations", results_dir)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(default_config_dir(), "result_inspection", overrides)
    return run(from_dict(ResultInspectionConfig, cfg.get("result_inspection") or cfg))


if __name__ == "__main__":
    main()
