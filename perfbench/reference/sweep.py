"""The plain whole-globe downscaling of one CRU-TS month, as the benchmark's
reference for the sweep.

From the month as the NetCDF holds it (south row first, NaN where there is
no land) and the HR elevation and land mask (NaN on ocean): the frame is
turned north-up, min-max normalized to [-1, 1] by its own extremes (NaN to
0), the elevation normalized the same way over land (ocean to 0), the LR
elevation and mask taken by top-left decimation (OpenCV's nearest rule for an
integer factor). The frame is reflect-padded on the bottom and right to a
grid of 128-px tiles at a stride of 128 - 2 * 8, each tile and its HR
elevation and mask go through the generator, and the HR tiles are blended
with separable linear ramps over the 32-px overlap, divided by the summed
weights, cropped, and mapped back to the month's units. Ocean is NaN.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import esrgan


def _minmax(a: np.ndarray) -> Tuple[np.ndarray, float, float]:
    lo, hi = float(np.nanmin(a)), float(np.nanmax(a))
    scale = 2.0 / (hi - lo + 1e-8)
    return np.nan_to_num(a * scale + (-1.0 - lo * scale), nan=0.0).astype(np.float32), lo, hi


def static_inputs(elev_hr: np.ndarray, mask_hr: np.ndarray, scale: int) -> Dict[str, np.ndarray]:
    """The month-invariant inputs: normalized HR elevation, the 0/1 HR mask and their LR decimations."""
    land = ~np.isnan(mask_hr)
    elev, _, _ = _minmax(np.where(land, elev_hr, np.nan).astype(np.float32))
    mask = land.astype(np.float32)
    return {"elev": elev, "mask": mask, "elev_lr": elev[::scale, ::scale], "mask_lr": mask[::scale, ::scale],
            "land": land}


def _ramp_window(tile: int, overlap: int) -> np.ndarray:
    w = np.ones(tile, np.float32)
    ramp = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
    w[:overlap], w[-overlap:] = ramp, ramp[::-1]
    return np.outer(w, w)


def _grid(size: int, tile: int, stride: int) -> Tuple[int, list]:
    steps = -(-(size - tile) // stride) if size > tile else 0
    padded = tile + steps * stride
    return padded, list(range(0, padded - tile + 1, stride))


def downscale_month(p: esrgan.Params, gen: dict, month: np.ndarray, static: Dict[str, np.ndarray],
                    device: torch.device, tile: int = 128, overlap: int = 8, block: int = 16,
                    conv: esrgan.Conv = esrgan.f32_conv) -> np.ndarray:
    """The month's (H*s, W*s) output in its units, NaN on ocean."""
    s = gen["scaling_factor"]
    frame, lo, hi = _minmax(np.flipud(month).astype(np.float32))
    h, w = frame.shape
    hp, ys = _grid(h, tile, tile - 2 * overlap)
    wp, xs = _grid(w, tile, tile - 2 * overlap)
    lr = np.stack([frame, static["elev_lr"], static["mask_lr"]])
    lr = np.pad(lr, ((0, 0), (0, hp - h), (0, wp - w)), mode="reflect")
    hr = np.pad(np.stack([static["elev"], static["mask"]]), ((0, 0), (0, (hp - h) * s), (0, (wp - w) * s)),
                mode="reflect")
    lr_t, hr_t = torch.from_numpy(lr).to(device), torch.from_numpy(hr).to(device)
    origins = [(y, x) for y in ys for x in xs]
    ht = tile * s
    win = torch.from_numpy(_ramp_window(ht, overlap * s)).to(device)
    canvas = torch.zeros(hp * s, wp * s, device=device)
    weight = torch.zeros(hp * s, wp * s, device=device)
    with torch.no_grad(), esrgan.exact_matmul():
        for i in range(0, len(origins), block):
            part = origins[i:i + block]
            x = torch.stack([lr_t[:, y:y + tile, xx:xx + tile] for y, xx in part])
            ex = torch.stack([hr_t[:, y * s:y * s + ht, xx * s:xx * s + ht] for y, xx in part])
            sr = esrgan.forward(p, gen, x, ex[:, :1], ex[:, 1:], conv)[:, 0]
            for (y, xx), t in zip(part, sr):
                canvas[y * s:y * s + ht, xx * s:xx * s + ht] += t * win
                weight[y * s:y * s + ht, xx * s:xx * s + ht] += win
    out = (canvas / weight.clamp_min(1e-8))[:h * s, :w * s].cpu().numpy()
    scale = 2.0 / (hi - lo + 1e-8)
    out = (out - (-1.0 - lo * scale)) / scale
    return np.where(static["land"], out, np.nan).astype(np.float32)


def read_tiff(path: str) -> np.ndarray:
    """A single-strip, uncompressed, little-endian float32 TIFF's raster."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian TIFF")
    (ifd,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from("<HHI", buf, ifd + 2 + 12 * i)
        fmt = {3: "<H", 4: "<I"}.get(typ)
        if fmt and count == 1:
            tags[tag] = struct.unpack_from(fmt, buf, ifd + 10 + 12 * i)[0]
    width, height, bits, offset = tags[256], tags[257], tags[258], tags[273]
    if bits != 32 or tags.get(259, 1) != 1:
        raise ValueError(f"{path}: not an uncompressed float32 raster")
    return np.frombuffer(buf, "<f4", count=width * height, offset=offset).reshape(height, width)


def month_gap(got: np.ndarray, ref: np.ndarray, land: np.ndarray, lo: float, hi: float) -> Tuple[float, int]:
    """(the widest |got - ref| on land over half the month's range, the pixels
    whose NaN-ness differs from ocean's)."""
    nan_wrong = int(np.count_nonzero(np.isnan(got) != ~land))
    diff = np.abs(got[land].astype(np.float64) - ref[land])
    gap = float(np.max(diff)) / ((hi - lo) / 2) if diff.size else 0.0
    return (gap if np.isfinite(gap) else float("inf")), nan_wrong


def month_range(month: np.ndarray) -> Tuple[float, float]:
    return float(np.nanmin(month)), float(np.nanmax(month))
