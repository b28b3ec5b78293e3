# -*- coding: utf-8 -*-
"""Preprocessing CLI: the port of ``climsr_tpu.cli.preprocess`` (reference
``climsr/cli/preprocess.py``): the 7 ETL steps in order, on the host.

One ``spawn`` pool of ``preprocessing.n_workers`` serves every step.

Usage: ``python -m climsr_tpu_torch.cli.preprocess preprocessing.output_path=<dir> ...``
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List, Optional

from climsr_tpu_torch.config.compose import compose, default_config_dir
from climsr_tpu_torch.config.schemas import PreProcessingConfig, from_dict
from climsr_tpu_torch.preprocessing import preprocessing

logger = logging.getLogger(__name__)

STEPS = (
    "run_cruts_to_tiff",
    "run_world_clim_resize",
    "run_tavg_rasters_generation",
    "run_world_clim_tiling",
    "run_statistics_computation",
    "run_train_val_test_split",
    "run_extent_extraction",
)


def run(cfg: PreProcessingConfig) -> Dict[str, float]:
    """Run the steps; returns each step's wall seconds (a step turned off: ~0)."""
    seconds = {}
    with preprocessing.worker_pool(cfg.n_workers) as pool:
        for step in STEPS:
            t0 = time.perf_counter()
            getattr(preprocessing, step)(cfg, pool)
            seconds[step] = time.perf_counter() - t0
    logger.info("Preprocessing finished in %.1fs: %s", sum(seconds.values()),
                ", ".join(f"{k} {v:.1f}s" for k, v in seconds.items()))
    return seconds


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(default_config_dir(), "preprocessing", overrides)
    return run(from_dict(PreProcessingConfig, cfg.get("preprocessing") or cfg))


if __name__ == "__main__":
    main()
