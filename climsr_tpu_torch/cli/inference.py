# -*- coding: utf-8 -*-
"""Inference CLI: the port of ``climsr_tpu.cli.inference`` (reference
``climsr/cli/inference.py``): per-variable SR over the CRU-TS series on the
card, then GeoTIFF -> NetCDF export.

Usage: ``python -m climsr_tpu_torch.cli.inference inference.pretrained_model=...
inference.generator_type=esrgan ...``; a leading ``--device=cpu`` runs on the
CPU.

``inference.spatial_shard=true`` shards every frame's rows over the ranks of
the world: called inside an initialized process group (``torchrun``, or a
caller's own group) it takes that group; otherwise, with more than one card,
it starts one NCCL rank per card. Rank 0 writes the GeoTIFFs and the NetCDF.
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional

import torch

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.compose import compose, default_config_dir
from climsr_tpu_torch.config.schemas import InferenceConfig, from_dict
from climsr_tpu_torch.device import DeviceLike
from climsr_tpu_torch.inference.run import run_inference, transform_tiff_files_to_net_cdf
from climsr_tpu_torch.parallel.launch import init_from_env, spawn
from climsr_tpu_torch.parallel.mesh import world

logger = logging.getLogger(__name__)


def _require(cfg: InferenceConfig, *names: str) -> None:
    """Fail fast on mandatory ('???') values instead of letting the literal
    string propagate into file paths / the generator registry — and instead of
    failing at the to_netcdf step AFTER the expensive inference pass."""
    missing = [n for n in names if getattr(cfg, n, None) in (None, "???")]
    if missing:
        raise ValueError(
            "Missing mandatory inference config value(s): "
            + ", ".join(f"inference.{n}" for n in missing)
        )


def run(cfg: InferenceConfig, generator_kwargs: Optional[dict] = None, device: DeviceLike = None) -> None:
    # `temp_only` and `extract_polygon_extent` are declared-but-never-read
    # knobs in the reference too (config.py:199,217); variable selection is
    # cruts_variable (null = all CRU-TS variables), as the reference CLI's
    variables = [cfg.cruts_variable] if cfg.cruts_variable else consts.cruts.variables_cts
    if cfg.run_inference:
        # the NetCDF path reads ds_path, the (default) GeoTIFF path tiff_dir
        source = "ds_path" if cfg.use_netcdf_datasets else "tiff_dir"
        _require(
            cfg, "pretrained_model", "generator_type", source,
            "elevation_file", "land_mask_file", "min_max_lookup", "inference_out_path",
        )
        if not cfg.normalize:  # z-score mode reads the stats feather up front
            _require(cfg, "zscore_lookup")
    if cfg.to_netcdf:
        _require(cfg, "extent_out_path_sr_nc")
    if cfg.run_inference:
        run_inference(cfg, variables, generator_kwargs, device=device)
    if world()[0] != 0:
        return
    if cfg.to_netcdf:
        # documented deviation (as in the JAX package): convert this run's SR
        # output, not `extent_out_path_sr`, which no reference code path writes
        transform_tiff_files_to_net_cdf(
            cfg.inference_out_path,
            cfg.extent_out_path_sr_nc,
            variables,
            prefix=cfg.generator_type,
        )


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> None:
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    while overrides and overrides[0].startswith("--device="):
        device = overrides.pop(0).split("=", 1)[1]
    cuda = device is None or torch.device(device).type == "cuda"
    init_from_env("cuda" if cuda else device)
    if cuda and world()[1] > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = compose(default_config_dir(), "inference", overrides)
    inference_cfg = from_dict(InferenceConfig, cfg.get("inference") or cfg)
    cards = torch.cuda.device_count() if cuda else 0
    if inference_cfg.spatial_shard and world()[1] == 1 and cards > 1:
        spawn("climsr_tpu_torch.cli.inference:main_rank", cards, {"argv": overrides}, backend="nccl")
        return
    run(inference_cfg, generator_kwargs=cfg.get("generator"), device=device)


def main_rank(argv: List[str]) -> None:
    """One rank of a multi-card run (started by :func:`main`), on its card."""
    main(argv)


if __name__ == "__main__":
    main()
