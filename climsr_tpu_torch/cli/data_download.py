# -*- coding: utf-8 -*-
"""Data-download CLI: the port of ``climsr_tpu.cli.data_download`` (reference
``climsr/cli/data_download.py``)."""
from __future__ import annotations

import logging
import sys
from typing import List, Optional

from climsr_tpu_torch.config.compose import compose, default_config_dir
from climsr_tpu_torch.config.schemas import DataDownloadConfig, from_dict
from climsr_tpu_torch.preprocessing.data_download import (
    get_cruts_data_download_urls,
    get_world_clim_future_climate_data_download_urls,
    get_world_clim_historical_climate_data_download_urls,
    get_world_clim_historical_weather_data_download_urls,
    handle_file_download,
)

logger = logging.getLogger(__name__)


def run(cfg: DataDownloadConfig) -> None:
    cruts_urls = get_cruts_data_download_urls()
    wc_urls = (
        get_world_clim_historical_climate_data_download_urls()
        + get_world_clim_historical_weather_data_download_urls()
        + get_world_clim_future_climate_data_download_urls()
    )
    logger.info("Downloading %d CRU-TS + %d WorldClim archives", len(cruts_urls), len(wc_urls))
    handle_file_download(cruts_urls, wc_urls, cfg.download_path)


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(default_config_dir(), "data_download", overrides)
    run(from_dict(DataDownloadConfig, cfg.get("data_download") or cfg))


if __name__ == "__main__":
    main()
