# -*- coding: utf-8 -*-
"""Dataset download: CRU-TS 4.05 + WorldClim 2.1 (historical, weather, CMIP6); the
port of ``climsr_tpu.preprocessing.data_download``, ``requests`` imported in the call.

Parity: reference ``climsr/preprocessing/data_download.py`` — identical URL
tables (CRU-TS per-variable gz archives; WorldClim base climate x
resolutions; historical weather decades; CMIP6 future scenarios over 9 GCMs x
4 SSPs), streaming downloads tolerating 404s (WorldClim gaps), 3-attempt
retry with integrity check via extraction, gz/zip handling, and the WorldClim
``share/spatial03/...`` folder-structure fixup.
"""
from __future__ import annotations

import gzip
import itertools
import logging
import os
import shutil
import traceback
import zipfile
from glob import glob
from typing import List, Optional, Tuple, Union

import climsr_tpu_torch.consts as consts

D = consts.datasets_and_preprocessing
WC = consts.world_clim
logger = logging.getLogger(__name__)

MAX_RETRY_COUNT = 3


def download_file(url: str, download_dir: str = "./datasets/download") -> Tuple[Union[str, None], Union[str, None]]:
    import requests

    os.makedirs(download_dir, exist_ok=True)
    fname = os.path.join(download_dir, url.split("/")[-1])
    if os.path.exists(fname):
        logger.info("File %s already exists. Skipping download...", fname)
        return fname, None

    resp = requests.get(url, stream=True)
    # WorldClim is missing files for some scenarios: 404 is a tolerated outcome
    if resp.status_code == 404:
        return None, resp.reason
    resp.raise_for_status()

    with open(fname, "wb") as f:
        for data in resp.iter_content(chunk_size=65536):
            f.write(data)
    return fname, None


def get_cruts_data_download_urls() -> List[str]:
    return [
        "https://crudata.uea.ac.uk/cru/data/hrg/cru_ts_4.05/cruts.2103051243.v4.05/"
        f"{var}/cru_ts4.05.1901.2020.{var}.dat.nc.gz"
        for var in consts.cruts.temperature_vars
    ]


def get_world_clim_historical_climate_data_download_urls() -> List[str]:
    variables = [WC.tmin, WC.tavg, WC.tmax, WC.elev]
    return [
        f"https://biogeo.ucdavis.edu/data/worldclim/v2.1/base/wc2.1_{res}_{var}.zip"
        for var, res in itertools.product(variables, WC.data_resolutions)
    ]


def get_world_clim_historical_weather_data_download_urls() -> List[str]:
    step = 10
    urls = []
    for var, lower in itertools.product([WC.tmin, WC.tmax], range(1960, 2019, step)):
        upper = lower + step - 1
        if upper == 2019:
            upper = 2018
        urls.append(f"https://biogeo.ucdavis.edu/data/worldclim/v2.1/hist/wc2.1_2.5m_{var}_{lower}-{upper}.zip")
    return urls


def get_world_clim_future_climate_data_download_urls() -> List[str]:
    step = 20
    urls = []
    for var, res, gcm, scenario, lower in itertools.product(
        [WC.tmin, WC.tmax], WC.data_resolutions, WC.GCMs, WC.scenarios, range(2021, 2100, step)
    ):
        upper = lower + step - 1
        urls.append(
            f"https://biogeo.ucdavis.edu/data/worldclim/v2.1/fut/{res}/"
            f"wc2.1_{res}_{var}_{gcm}_{scenario}_{lower}-{upper}.zip"
        )
    return urls


def gunzip(source_filepath: str, dest_filepath: str, block_size: int = 65536) -> None:
    with gzip.open(source_filepath, "rb") as s_file, open(dest_filepath, "wb") as d_file:
        while True:
            block = s_file.read(block_size)
            if not block:
                break
            d_file.write(block)


def unzip(source_filepath: str, dest_filepath: str) -> None:
    os.makedirs(dest_filepath, exist_ok=True)
    with zipfile.ZipFile(source_filepath, "r") as zip_ref:
        zip_ref.extractall(dest_filepath)


def handle_file_extraction(f_name: str, replace_underscore: bool = False) -> None:
    logger.info("Extracting %s", f_name)
    extraction_path = os.path.splitext(f_name)[0].replace(D.archives, D.extracted)
    if replace_underscore:
        extraction_path = extraction_path.replace("_", os.sep)
    if os.path.exists(extraction_path):
        logger.info("File %s was already extracted... Skipping...", f_name)
        return
    try:
        if f_name.endswith(".zip"):
            unzip(f_name, extraction_path)
        elif f_name.endswith(".gz"):
            os.makedirs(os.path.dirname(extraction_path), exist_ok=True)
            gunzip(f_name, extraction_path)
        else:
            raise ValueError(f"{f_name} compression type is unsupported! Supported: ZIP, GZ")
    except Exception:
        # remove the partial extraction RECURSIVELY — a non-empty dir left
        # behind would pass the 'already extracted' check on the retry and
        # accept a corrupt/incomplete dataset
        if os.path.isfile(extraction_path):
            os.remove(extraction_path)
        elif os.path.isdir(extraction_path):
            import shutil

            shutil.rmtree(extraction_path, ignore_errors=True)
        raise


def try_file_download_and_extraction(url: str, download_path: str, replace_underscore_flag: bool = False) -> None:
    retry = 0
    while retry < MAX_RETRY_COUNT:
        if retry > 0:
            logger.warning("Re-downloading %s (integrity failure). Attempt #%d", url, retry + 1)
        f_name, error = download_file(url, download_path)
        if f_name is None:
            logger.info("File %s could not be downloaded: %s", url, error)
            break
        try:
            handle_file_extraction(f_name, replace_underscore_flag)
            break
        except Exception as ex:
            logger.error("File %s could not be extracted: %s\n%s", url, ex, traceback.format_exc())
            os.remove(f_name)
        retry += 1
    if retry == MAX_RETRY_COUNT:
        logger.error("Maximum retries for %s reached. Re-download manually.", url)


def fix_paths_for_world_clim(world_clim_download_path: str) -> None:
    """Flatten the CMIP6 ``share/spatial03/worldclim/cmip6/7_fut/...`` nesting."""
    extraction_path = os.path.join(world_clim_download_path, D.extracted, D.world_clim_main_extraction_folder)
    files = glob(os.path.join(extraction_path, "**/*.tif"), recursive=True)
    logger.info("Fixing WorldClim folder structure: %d files under %s", len(files), extraction_path)

    lookup = [
        f"share/spatial03/worldclim/cmip6/7_fut/{res}/{gcm}/{scenario}/"
        for res, gcm, scenario in itertools.product(WC.data_resolutions, WC.GCMs, WC.scenarios)
    ]
    for fp in files:
        for lookup_str in lookup:
            if lookup_str in fp:
                shutil.move(fp, fp.replace(lookup_str, ""))
                break
    for directory in glob(os.path.join(extraction_path, "**/share"), recursive=True):
        shutil.rmtree(directory)


def handle_file_download(
    cru_ts_download_urls: List[str],
    world_clim_download_urls: List[str],
    download_path: str = "./datasets/download",
) -> None:
    cruts_path = os.path.join(download_path, D.cruts_download_dir, D.archives)
    wc_path = os.path.join(download_path, D.world_clim_download_dir, D.archives)
    os.makedirs(cruts_path, exist_ok=True)
    os.makedirs(wc_path, exist_ok=True)

    tasks = [(url, cruts_path, False) for url in cru_ts_download_urls]
    tasks += [(url, wc_path, True) for url in world_clim_download_urls]
    for idx, (url, path, flag) in enumerate(tasks):
        logger.info("PROGRESS: %d/%d", idx + 1, len(tasks))
        try_file_download_and_extraction(url, path, flag)

    fix_paths_for_world_clim(os.path.join(download_path, D.world_clim_download_dir))
