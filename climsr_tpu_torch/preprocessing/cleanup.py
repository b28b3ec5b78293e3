# -*- coding: utf-8 -*-
"""Standalone parallel file-deletion tool: the port of ``climsr_tpu.preprocessing.cleanup``.

Parity: reference ``climsr/preprocessing/cleanup.py`` (a dask-parallel
recursive deleter) on a plain process pool.

Usage: ``python -m climsr_tpu_torch.preprocessing.cleanup --dir <path> [--pattern '*.tif']``
"""
from __future__ import annotations

import argparse
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

logger = logging.getLogger(__name__)


def remove_file(fp: str) -> None:
    try:
        os.remove(fp)
    except OSError as e:
        logger.warning("Could not remove %s: %s", fp, e)


def cleanup(directory: str, pattern: str = "**/*", n_workers: int = 8) -> int:
    files = [fp for fp in glob(os.path.join(directory, pattern), recursive=True) if os.path.isfile(fp)]
    logger.info("Removing %d files under %s", len(files), directory)
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        list(pool.map(remove_file, files))
    return len(files)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dir", required=True)
    parser.add_argument("--pattern", default="**/*")
    parser.add_argument("--n_workers", type=int, default=8)
    args = parser.parse_args()
    cleanup(args.dir, args.pattern, args.n_workers)


if __name__ == "__main__":
    main()
