# -*- coding: utf-8 -*-
"""Batch inference: checkpoint -> generator on the card -> GeoTIFF per month -> NetCDF.

The port of ``climsr_tpu.inference.run`` (reference
``climsr/inference/inference.py``):

- ``run_inference``: per-variable checkpoint load, min-max lookup filter
  (dataset == 'cru-ts'), NetCDF vs GeoTIFF dataset choice, full-image SR,
  denormalize + NaN ocean mask, GeoTIFF written with the land-mask profile,
- ``transform_tiff_files_to_net_cdf``: monthly GeoTIFFs -> CF-1.4 NetCDF named
  ``{prefix}.cru_ts4.05.nn.inference.1901.2020.{var}.dat.nc``.

Frames larger than 160x160 LR are overlap-tiled (128-px tiles, 8-px overlap)
and swept in groups of months; only the land pixels come back to the host,
12-bit packed under min-max normalization and as f16 otherwise. Writer threads
read each group back and write the GeoTIFFs while the card runs the next.
Under ``utils.profiling.recording`` the month list and the tiled sweep's
stages record ``climsr.sweep.*`` spans and count the groups and months.
"""
from __future__ import annotations

import logging
import os
import re
from glob import glob
from typing import List, Optional

import numpy as np
import torch
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.schemas import READBACKS
from climsr_tpu_torch.data.normalization import MinMaxScaler, StandardScaler
from climsr_tpu_torch.data.tables import read_feather
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset, GeoTiffInferenceDataset
from climsr_tpu_torch.inference.tiled import TiledSR, whole_frame_sr
from climsr_tpu_torch.interop.params import load_generator_checkpoint
from climsr_tpu_torch.io.geotiff import GeoProfile, read_geotiff, write_geotiff
from climsr_tpu_torch.io.netcdf import stack_monthly_rasters, write_climate_series
from climsr_tpu_torch.models import FUSION_GENERATORS, PRE_UPSCALED_GENERATORS, create_generator
from climsr_tpu_torch.ops.pack12 import unpack12
from climsr_tpu_torch.parallel.halo import spatial_sharded_apply_multi
from climsr_tpu_torch.parallel.mesh import all_gather_dim, axis_info, create_mesh, world
from climsr_tpu_torch.utils import profiling

B = consts.batch_items
D = consts.datasets_and_preprocessing
logger = logging.getLogger(__name__)



def load_generator(
    pretrained_model: str,
    generator_type: str,
    generator_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
) -> nn.Module:
    """A generator with weights from a reference ``.ckpt`` / ``state_dict``
    file, in bf16 on ``device`` (``None`` means ``cuda``), in eval mode."""
    kwargs = {k: v for k, v in (generator_kwargs or {}).items() if k != "name"}
    model = create_generator(generator_type, dtype=torch.bfloat16, device=device, **kwargs)
    model.load_state_dict(load_generator_checkpoint(pretrained_model, generator_type), strict=True)
    return model


def make_generator_fn(model: nn.Module, generator_type: str):
    """(lr[, elev, mask]) NHWC -> sr NHWC, matching the task-layer call dispatch.

    NHWC in and out; the module sees NCHW views with ``channels_last`` strides
    (a permute, no copy), cast to its parameters' dtype (the tiler uploads
    bf16, as the JAX package's does)."""
    dtype = next(model.parameters()).dtype

    def nchw(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 3, 1, 2).to(dtype)

    if generator_type in FUSION_GENERATORS:

        def fn(lr, elev, mask):
            with torch.inference_mode():
                return model(nchw(lr), nchw(elev), nchw(mask)).permute(0, 2, 3, 1)

    else:

        def fn(lr, *_):
            with torch.inference_mode():
                return model(nchw(lr)).permute(0, 2, 3, 1)

    return fn


def inference_on_full_images(
    model: nn.Module,
    ds,
    out_dir: str,
    generator_type: str,
    normalization_range=(-1.0, 1.0),
    batch_size: int = 8,
    tile_size: Optional[int] = None,
    tile_overlap: int = 16,
    scaling_factor: int = 4,
    spatial_shard: bool = False,
    spatial_halo: int = 32,
    readback: str = "pack12",
    device: DeviceLike = None,
) -> List[str]:
    """SR every frame in ``ds``; write one GeoTIFF per frame. Returns paths.

    ``readback``: transport encoding of the land vector on the tiled path —
    ``"pack12"`` (12-bit fixed point, 1.5 B/px, worst-case abs error 3.7e-4 on
    the normalized output; used only under a ``MinMaxScaler``, whose output is
    in [-1, 1]) or ``"f16"`` (2 B/px). ``model`` must already be on ``device``.
    ``spatial_shard`` with several ranks whose count divides the frame
    height runs :func:`_spatial_sharded_sr` with halo ``spatial_halo``; rank
    0 writes and returns the paths, the other ranks return ``[]``. On one
    rank it warns and takes the tiled path, as the JAX package.
    """
    if readback not in READBACKS:
        raise ValueError(f"readback must be one of {READBACKS}, got {readback!r}")
    dev = resolve_device(device)
    param = next(model.parameters(), None)
    if param is not None and param.device.type != dev.type:
        raise ValueError(f"the model is on {param.device}, the run asks for {dev}")
    os.makedirs(out_dir, exist_ok=True)
    # Denormalize with the SAME scaler family the dataset normalized with.
    scaler = getattr(ds, "scaler", None)
    if scaler is None:
        scaler = MinMaxScaler(feature_range=tuple(normalization_range))
    _, mask_profile = read_geotiff(ds.land_mask_file)
    mask_np = ds.mask_np

    gen_fn = make_generator_fn(model, generator_type)
    n = len(ds)
    written: List[str] = []

    frames = []
    metas = []
    for i in range(n):
        with profiling.span("climsr.sweep.load_month", key=i):
            item = ds[i]
        frames.append(item[B.lr])
        metas.append((item[B.filename], float(item[B.min]), float(item[B.max])))
    frames = np.stack(frames)

    extras = (ds.elevation_data, ds.mask_hr) if generator_type in FUSION_GENERATORS else None

    # Multi-rank whole-globe mode: every rank SRs its H-slice of every frame
    # with one halo exchange (parallel/halo.py); rank 0 writes the outputs
    rank, n_dev = world()
    if spatial_shard:
        if n_dev > 1 and frames.shape[1] % n_dev == 0:
            sr_frames = _spatial_sharded_sr(model, generator_type, frames, extras, spatial_halo, scaling_factor,
                                            batch_size, dev)
            if rank != 0:
                return written
            return _write_outputs(sr_frames, metas, scaler, mask_np, mask_profile, out_dir, written)
        logger.warning(
            "inference.spatial_shard requested but %d device(s) / H=%d not shardable; "
            "falling back to the tiled path", n_dev, frames.shape[1],
        )

    lr_pixels = frames.shape[1] * frames.shape[2]
    if tile_size is None and lr_pixels > 160 * 160:
        tile_size = 128
        tile_overlap = min(tile_overlap, 8)
        logger.info("frame %dx%d: using overlap-tiled SR (tile=%d, overlap=%d)",
                    frames.shape[1], frames.shape[2], tile_size, tile_overlap)

    if tile_size and (frames.shape[1] > tile_size or frames.shape[2] > tile_size):
        # srcnn consumes a pre-upscaled frame (HR in, HR out): scale 1
        out_scale = 1 if generator_type in PRE_UPSCALED_GENERATORS else scaling_factor
        # tiles per generator call scale inversely with tile area, capped at 64
        chunk = min(64, max(1, (batch_size * 8 * 64 * 64) // (tile_size * tile_size)))
        # ship only the LAND pixels back (~29% of a CRU-TS frame)
        land_idx = np.flatnonzero(np.asarray(mask_np).ravel())
        use_pack = land_idx.size < mask_np.size  # degenerate all-land masks: skip
        # pack12 clamps to (-1.5, 1.5): only min-max normalized output fits it
        use_pack12 = use_pack and readback == "pack12" and isinstance(scaler, MinMaxScaler)
        if use_pack and readback == "pack12" and not use_pack12:
            logger.warning("pack12 readback needs min-max normalized output; reading back f16 under %s",
                           type(scaler).__name__)

        tiler = TiledSR(
            gen_fn, scale=out_scale, tile_size=tile_size, overlap=tile_overlap,
            batch_size=chunk, output_dtype=torch.float16,
            pack_indices=land_idx if use_pack else None, pack12=use_pack12, device=dev,
        )
        tiler.set_extras(extras)  # elevation/mask are frame-invariant: upload once
        # [climate, elevation_lr, mask_lr]: only channel 0 varies by month
        if frames.shape[-1] > 1 and all(
            np.array_equal(frames[0, ..., 1:], frames[i, ..., 1:])
            for i in (frames.shape[0] // 2, frames.shape[0] - 1)
        ):
            tiler.set_static_lr_channels(frames[0, ..., 1:])
            frames = frames[..., :1]
        return _pipelined_tiled_sweep(
            tiler, frames, metas, scaler, mask_np, mask_profile, out_dir, written,
            out_scale, land_idx=land_idx if use_pack else None, pack12=use_pack12,
        )
    sr_frames = whole_frame_sr(gen_fn, frames, extras=extras, batch_size=batch_size, device=dev)
    return _write_outputs(sr_frames, metas, scaler, mask_np, mask_profile, out_dir, written)


def _spatial_sharded_sr(model: nn.Module, generator_type: str, frames: np.ndarray, extras, spatial_halo: int,
                        scaling_factor: int, batch_size: int, dev: torch.device) -> np.ndarray:
    """Whole frames SR'd jointly by the ranks of the world
    (``climsr_tpu/inference/run.py:130-170``): rank r runs
    ``spatial_sharded_apply_multi`` over rows [r*Hl, (r+1)*Hl) of every frame
    and of the HR extras, the halo capped at ``Hl - 1`` (the reflection at
    the frame edges reads the shard's own rows); the frames' outputs are
    all-gathered. RCAN runs as a clone with the exact channel-attention pool."""
    mesh = create_mesh()
    _, rank, n = axis_info(mesh, "data")
    hl = frames.shape[1] // n
    halo = min(spatial_halo, hl - 1)
    out_scale = 1 if generator_type in PRE_UPSCALED_GENERATORS else scaling_factor
    scales = (1, out_scale, out_scale) if extras is not None else (1,)
    mdl = model.clone(spatial_axis=axis_info(mesh, "data"), spatial_halo=halo) \
        if hasattr(model, "spatial_axis") else model
    dtype = next(model.parameters()).dtype
    sharded = spatial_sharded_apply_multi(lambda *xs: mdl(*xs), mesh, halo=halo, scale=out_scale,
                                          input_scales=scales)

    def gen_fn(*xs: torch.Tensor) -> torch.Tensor:  # NHWC local slices -> NHWC whole frames
        out = sharded(*[x.permute(0, 3, 1, 2).to(dtype) for x in xs])
        return all_gather_dim(out.contiguous(), 2, axis_info(mesh, "data")[0], n).permute(0, 2, 3, 1)

    local = frames[:, rank * hl:(rank + 1) * hl]
    local_extras = None if extras is None else tuple(
        np.asarray(e)[rank * hl * out_scale:(rank + 1) * hl * out_scale] for e in extras)
    logger.info("spatial-sharded whole-frame SR over %d ranks (halo=%d LR rows)", n, halo)
    return whole_frame_sr(gen_fn, local, extras=local_extras, batch_size=batch_size, compute_dtype=dtype, device=dev)


def _denormalize(scaler, arr: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Scaler-family-aware denormalization: z-score needs no per-frame range."""
    if isinstance(scaler, StandardScaler):
        return scaler.denormalize(arr)
    return scaler.denormalize(arr, vmin, vmax)


def _pipelined_tiled_sweep(
    tiler, frames, metas, scaler, mask_np, mask_profile, out_dir, written,
    scaling_factor: int, max_in_flight: int = 3, land_idx: Optional[np.ndarray] = None,
    group_size: int = 8, pack12: bool = False,
) -> List[str]:
    """Overlap the device sweep with host IO.

    Frames go to the card in GROUPS of ``group_size``; the main thread only
    enqueues the work (the device tensor comes back at once), and a writer
    pool reads each group back (``.cpu()``, which waits for THAT group),
    denormalizes in f32 and writes the GeoTIFFs. ``max_in_flight`` bounds the
    groups whose outputs live on the card. The final short group is padded by
    repeating the last frame; its padded outputs are dropped.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    h, w = frames.shape[1], frames.shape[2]
    hr_h, hr_w = h * scaling_factor, w * scaling_factor
    profile = GeoProfile(
        width=hr_w, height=hr_h,
        origin_x=mask_profile.origin_x, origin_y=mask_profile.origin_y,
        pixel_size_x=mask_profile.pixel_size_x, pixel_size_y=mask_profile.pixel_size_y,
        nodata=np.nan,
    )
    mask_bool = np.asarray(mask_np, bool)
    n = frames.shape[0]
    k = min(group_size, n)

    def write_group(gi, i0, count, dev_out, enqueued):
        # the group's spans on this thread hang under its enqueue span
        def stage(name):
            return profiling.span(name, key=gi, parent=enqueued)

        with stage("climsr.sweep.readback"):
            host = dev_out.cpu().numpy()  # ONE readback per group on this thread
        paths = []
        for j in range(count):
            filename, vmin, vmax = metas[i0 + j]
            # promote the f16 readback to f32 BEFORE denormalizing
            if land_idx is not None:
                with stage("climsr.sweep.unpack12"):
                    vals = unpack12(host[j], land_idx.size) if pack12 else host[j].astype(np.float32)
                with stage("climsr.sweep.denormalize"):
                    vals = _denormalize(scaler, vals, vmin, vmax)
                    arr = np.full((hr_h, hr_w), np.nan, np.float32)
                    arr.ravel()[land_idx] = vals
            else:
                with stage("climsr.sweep.denormalize"):
                    arr = host[j][:hr_h, :hr_w].astype(np.float32)
                    arr = _denormalize(scaler, arr, vmin, vmax)
                    arr = np.where(mask_bool, arr, np.nan).astype(np.float32)
            out_path = os.path.join(out_dir, filename)
            with stage("climsr.sweep.write"):
                write_geotiff(out_path, arr, profile)
            paths.append(out_path)
        return paths

    def collect():
        j, fut = pending.popleft()
        with profiling.span("climsr.sweep.writer_wait", key=j):
            group_paths[j] = fut.result()
        profiling.count("climsr.sweep.months", len(group_paths[j]))

    group_paths: List[Optional[List[str]]] = [None] * (-(-n // k))
    pending: "deque" = deque()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for gi, i0 in enumerate(range(0, n, k)):
            chunk = frames[i0 : i0 + k]
            count = chunk.shape[0]
            if count < k:  # pad the tail group to the group size
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], k - count, axis=0)])
            with profiling.span("climsr.sweep.enqueue", key=gi) as enqueued:
                dev_out = tiler.device_call_many(chunk)
            profiling.count("climsr.sweep.groups")
            pending.append((gi, pool.submit(write_group, gi, i0, count, dev_out, enqueued)))
            if len(pending) >= max_in_flight:
                collect()
        while pending:
            collect()
    for paths in group_paths:
        written.extend(paths)
    return written


def _write_outputs(sr_frames, metas, scaler, mask_np, mask_profile, out_dir, written) -> List[str]:
    """Denormalize + ocean-mask each SR frame and write one GeoTIFF per month."""
    profile = GeoProfile(
        width=sr_frames.shape[2],
        height=sr_frames.shape[1],
        origin_x=mask_profile.origin_x,
        origin_y=mask_profile.origin_y,
        pixel_size_x=mask_profile.pixel_size_x,
        pixel_size_y=mask_profile.pixel_size_y,
        nodata=np.nan,
    )
    for i, (filename, vmin, vmax) in enumerate(metas):
        arr = _denormalize(scaler, sr_frames[i][..., 0], vmin, vmax)
        arr = np.where(mask_np, arr, np.nan).astype(np.float32)
        out_path = os.path.join(out_dir, filename)
        write_geotiff(out_path, arr, profile)
        written.append(out_path)
    return written


def run_inference(cfg, cruts_variables: List[str], generator_kwargs: Optional[dict] = None,
                  device: DeviceLike = None) -> None:
    """Inference for each CRU-TS variable. ``cfg`` carries the fields of
    ``InferenceConfig`` (pretrained_model, generator_type, min_max_lookup,
    ds_path, ...) as attributes. The feather lookups are read with
    ``read_feather``."""
    dev = resolve_device(device)
    model = load_generator(cfg.pretrained_model, cfg.generator_type, generator_kwargs, device=dev)
    min_max_all = read_feather(cfg.min_max_lookup)
    zscore = None if cfg.normalize else read_feather(cfg.zscore_lookup)
    for var in cruts_variables:
        out_path = os.path.join(cfg.inference_out_path, var)
        os.makedirs(out_path, exist_ok=True)
        logger.info("Running inference for variable: %s with model: %s", var, cfg.pretrained_model)

        min_max_lookup = min_max_all.filter(
            (min_max_all[D.dataset] == "cru-ts") & (min_max_all[D.variable] == var)
        )
        common = dict(
            elevation_file=cfg.elevation_file,
            land_mask_file=cfg.land_mask_file,
            generator_type=cfg.generator_type,
            scaling_factor=cfg.scaling_factor,
            normalize=cfg.normalize,
            standardize=not cfg.normalize,
            standardize_stats=zscore,
            normalize_range=tuple(cfg.normalization_range),
            use_elevation=cfg.use_elevation,
            use_mask=cfg.use_mask,
        )
        if cfg.use_netcdf_datasets:
            ds = CRUTSInferenceDataset(ds_path=cfg.ds_path, **common)
        else:
            ds = GeoTiffInferenceDataset(
                tiff_dir=os.path.join(cfg.tiff_dir, var), tiff_df=min_max_lookup, variable=var,
                use_global_min_max=cfg.use_global_min_max, **common,
            )

        inference_on_full_images(
            model,
            ds,
            out_dir=out_path,
            generator_type=cfg.generator_type,
            normalization_range=tuple(cfg.normalization_range),
            batch_size=cfg.batch_size,
            tile_size=cfg.tile_size,
            tile_overlap=cfg.tile_overlap,
            scaling_factor=cfg.scaling_factor,
            spatial_shard=cfg.spatial_shard,
            spatial_halo=cfg.spatial_halo,
            readback=getattr(cfg, "readback", "pack12"),
            device=dev,
        )
        logger.info("Inference for variable %s finished.", var)


def transform_tiff_files_to_net_cdf(
    tiff_dir: str,
    nc_out_path: str,
    cruts_variables: List[str],
    prefix: str = "inference",
) -> None:
    os.makedirs(nc_out_path, exist_ok=True)
    for var in cruts_variables:
        fps = sorted(glob(os.path.join(tiff_dir, var, "*.tif")))
        if not fps:
            logger.warning("No GeoTIFFs for %s under %s", var, tiff_dir)
            continue
        timestamps = []
        arrs = []
        profile = None
        for fp in fps:
            name = os.path.basename(fp).replace(".tif", "")
            m = re.search(r"(\d{4}-\d{2}-\d{2})$", name)
            timestamps.append(np.datetime64(m.group(1) if m else "1901-01-01"))
            arr, profile = read_geotiff(fp)
            arrs.append(arr)
        h, w = arrs[0].shape
        # GeoTIFF rasters are north-up; CRU-TS NetCDF stores lat ascending
        # from the south — flip the rows (the reader flipud's each frame)
        lat = (profile.origin_y - (np.arange(h) + 0.5) * profile.pixel_size_y)[::-1].copy()
        lon = profile.origin_x + (np.arange(w) + 0.5) * profile.pixel_size_x
        arrs = [a[::-1] for a in arrs]
        series = stack_monthly_rasters(arrs, timestamps, lat, lon, var)
        out = os.path.join(nc_out_path, f"{prefix}.cru_ts4.05.nn.inference.1901.2020.{var}.dat.nc")
        write_climate_series(
            out,
            series,
            title=f"CRU TS4.05 {D.var_to_variable.get(var, var)}",
        )
        logger.info("Wrote %s", out)
