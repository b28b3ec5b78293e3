#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch/H100 port's main path on one card and check it.

The main path is the ESRGAN tiled whole-globe inference sweep of
``climsr_tpu_torch`` at the flagship width (nf=64, nb=11, gc=16, one output
channel, bf16): CRU-TS months of 360x720 LR cut into 128-px tiles with 8-px
overlap, 16 tiles per generator call, feather blend, land gather, 12-bit
packed readback and one GeoTIFF per month. Its one hand-written kernel is the
fused residual dense block (``climsr_tpu_torch/csrc/rdb_fwd.cu``), 33
launches per generator call.

Phases (each raises on failure; nothing is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for the comparisons,
2. build: the kernel library from ``climsr_tpu_torch/csrc`` with ``nvcc``,
3. kernel against its plain version at the main path's shape (16 x 64 x
   128 x 128) and a ragged one (2 x 64 x 45 x 91), with and without the
   folded residual, in bf16 and f32; times (CUDA events, medians) beside
   the bound,
4. the full-width generator (seeded weights) on 16 tiles of 32x32 through the
   kernel and through the plain RDB, in bf16 and f32; 33 launches per forward,
5. end to end: a synthetic globe (8 months of 360x720 NetCDF, 1440x2880
   elevation and land mask at 29% land) through ``CRUTSInferenceDataset`` and
   ``inference_on_full_images``; 8 GeoTIFFs, launches = 33 x 14 generator
   calls, outputs against the same sweep with the plain RDB; a third sweep
   under ``torch.profiler`` for the device's busy share and top kernels,
6. one JSON line per kernel, then the device line as the last line.

Usage: ``python3 chip_smoke.py`` (one CUDA card). Exits non-zero, printing no
result, where there is no card or no ``climsr_tpu_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| / max |plain|: f32 differs by summation order only; bf16
# also by where each side rounds its intermediates (cuDNN rounds every conv's
# output and bias add to bf16, the kernel keeps f32 sums and rounds once)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the same bound for the whole generator: 33 blocks and the head compound the
# per-block differences above (bf16), or summation order (f32)
GENERATOR_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

NF, NB, GC = 64, 11, 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rdb_inputs(n, h, w, dtype, device, nf=NF, gc=GC):
    """x, x0 (N, nf, H, W) channels_last and five (weight, bias) pairs, from seed 0."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def act():
        t = torch.randn(n, nf, h, w, generator=gen)
        return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)

    x, x0 = act(), act()
    weights = []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        bound = 1.0 / (9 * cin) ** 0.5
        wt = (torch.rand(cout, cin, 3, 3, generator=gen) * 2 - 1) * bound
        bs = (torch.rand(cout, generator=gen) * 2 - 1) * bound
        weights.append((wt.to(device, dtype), bs.to(device, dtype)))
    return x, x0, weights


def rdb_bound_ms(x: torch.Tensor, with_x0: bool, nf=NF, gc=GC):
    """Least time for one RDB on an H100 and what sets it: the larger of its
    operations over the peak rate of x's dtype and its bytes (x, x0, out once,
    packed f32 weights) over the memory rate. Returns (ms, "operations"|"bytes")."""
    n, _, h, w = x.shape
    macs_per_px = 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)
    flops = 2.0 * macs_per_px * n * h * w
    weight_bytes = 4 * (9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf) + 4 * gc + nf)
    moved = x.numel() * x.element_size() * (3 if with_x0 else 2) + weight_bytes
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel(device) -> dict:
    """Kernel against rdb_reference; returns the main path's numbers."""
    from climsr_tpu_torch.ops.rdb import fused_rdb, pack_rdb_weights, rdb_reference

    result = {}
    for n, h, w in ((16, 128, 128), (2, 45, 91)):
        for dtype in (torch.float32, torch.bfloat16):
            x, x0, weights = rdb_inputs(n, h, w, dtype, device)
            packed = pack_rdb_weights(weights, dtype)
            for res in (None, x0):
                got = fused_rdb(x, weights, res, packed)
                torch.cuda.synchronize()
                ref = rdb_reference(x, weights, res)
                abs_err = (got.float() - ref.float()).abs().max().item()
                rel = abs_err / ref.float().abs().max().item()
                tag = f"fused_rdb {n}x{NF}x{h}x{w} {str(dtype)[6:]} x0={res is not None}"
                print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {KERNEL_TOL[dtype]:g})")
                if not (rel <= KERNEL_TOL[dtype]):
                    raise AssertionError(f"{tag}: kernel disagrees with rdb_reference ({rel:.3e})")
                if (n, h, w, dtype) == (16, 128, 128, torch.bfloat16):
                    ms = cuda_ms(lambda: fused_rdb(x, weights, res, packed))
                    plain = cuda_ms(lambda: rdb_reference(x, weights, res))
                    bound, bound_by = rdb_bound_ms(x, res is not None)
                    print(f"# {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                          f"bound {bound:.4f} ms ({bound_by})")
                    if res is None:
                        result = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by=bound_by)
    return result


def device_breakdown(run, top: int = 6) -> None:
    """Run ``run()`` under ``torch.profiler`` and print the device's busy share
    of the wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"# profiled sweep: {wall_us / 1e6:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / wall_us:.1f}%; no device time means the trace saw no kernels)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"#   {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:100]}")


@contextlib.contextmanager
def plain_rdb():
    """Run ESRGAN's dense blocks through rdb_reference instead of the kernel."""
    from climsr_tpu_torch.models import esrgan
    from climsr_tpu_torch.ops.rdb import rdb_reference

    kernel = esrgan.fused_rdb
    esrgan.fused_rdb = lambda x, weights, x0=None, packed=None: rdb_reference(x, weights, x0)
    try:
        yield
    finally:
        esrgan.fused_rdb = kernel


def seeded_esrgan(device, dtype, nf=NF, nb=NB, gc=GC):
    from climsr_tpu_torch.models import create_generator

    gen = torch.Generator(device="cpu").manual_seed(0)
    return create_generator(
        "esrgan", dtype=dtype, generator=gen, device=device,
        in_channels=3, out_channels=1, nf=nf, nb=nb, gc=gc,
    )


def phase_generator(device, nf=NF, nb=NB, gc=GC, n=16, lr=32) -> None:
    """The full-width generator through the kernel and through the plain RDB."""
    from climsr_tpu_torch.ops.rdb import fused_rdb

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, 3, lr, lr)).astype(np.float32))
    elev = torch.from_numpy(rng.normal(size=(n, 1, 4 * lr, 4 * lr)).astype(np.float32))
    mask = torch.from_numpy((rng.random((n, 1, 4 * lr, 4 * lr)) > 0.3).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        model = seeded_esrgan(device, dtype, nf, nb, gc)
        args = [t.to(device, dtype).contiguous(memory_format=torch.channels_last) for t in (x, elev, mask)]
        with torch.inference_mode():
            before = fused_rdb.launches
            got = model(*args)
            launched = fused_rdb.launches - before
            with plain_rdb():
                ref = model(*args)
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        print(f"# generator nf={nf} nb={nb} gc={gc} {n}x{lr}x{lr} -> {tuple(got.shape)} {str(dtype)[6:]}: "
              f"relative err vs plain {rel:.3e} (tol {GENERATOR_TOL[dtype]:g}), {launched} RDB launches")
        if got.shape != (n, 1, 4 * lr, 4 * lr) or not torch.isfinite(got).all():
            raise AssertionError("generator output has the wrong shape or non-finite values")
        if not (rel <= GENERATOR_TOL[dtype]):
            raise AssertionError(f"generator kernel path disagrees with the plain path ({rel:.3e})")
        if device.type == "cuda" and launched != 3 * nb:
            raise AssertionError(f"expected {3 * nb} RDB launches per forward, counted {launched}")


def make_globe(root: Path, months: int, h: int, w: int, scale: int = 4) -> None:
    """Synthetic CRU-TS world, as scripts/bench_whole_globe.py builds it: NetCDF
    months with a polar ocean strip, elevation, and a smooth land mask thresholded
    at the real 29% land fraction (about 26% once the polar strip is ocean)."""
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff
    from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series

    hr_h, hr_w = h * scale, w * scale
    strip = h // 9  # 40 of 360 rows
    rng = np.random.default_rng(0)
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, :strip, :] = np.nan
    tstamps = np.array([f"{1901 + m // 12}-{m % 12 + 1:02d}-16" for m in range(months)], dtype="datetime64[D]")
    write_climate_series(
        root / "cru_ts4.05.1901.2020.tmp.dat.nc",
        ClimateSeries("tmp", data, tstamps, np.linspace(-89, 89, h), np.linspace(-179, 179, w)),
    )
    blob = max(1, hr_h // 36)
    field = rng.normal(size=(-(-hr_h // blob), -(-hr_w // blob))).astype(np.float32)
    field = np.kron(field, np.ones((blob, blob), np.float32))[:hr_h, :hr_w]
    for ax in (0, 1):  # cheap separable smoothing
        acc = np.zeros_like(field)
        for d in range(-(blob // 2), blob // 2 + 1):
            acc += np.roll(field, d, axis=ax)
        field = acc / (2 * (blob // 2) + 1)
    mask_hr = np.where(field >= np.quantile(field, 0.71), 1.0, np.nan).astype(np.float32)
    mask_hr[: strip * scale, :] = np.nan
    write_geotiff(root / "land_mask.tif", mask_hr, GeoProfile.global_grid(hr_h, hr_w))
    elev = rng.normal(500, 300, size=(hr_h, hr_w)).astype(np.float32)
    write_geotiff(root / "elevation.tif", elev, GeoProfile.global_grid(hr_h, hr_w, nodata=None))


def phase_globe(device, months=8, h=360, w=720, nf=NF, nb=NB, gc=GC, dtype=torch.bfloat16,
                tile_size=None, tile_overlap=16) -> dict:
    """The whole-globe sweep through the kernel, checked against the plain RDB."""
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.ops.pack12 import MAX_ABS_ERR
    from climsr_tpu_torch.ops.rdb import fused_rdb

    scale = 4
    with tempfile.TemporaryDirectory(prefix="climsr_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        make_globe(root, months, h, w, scale)
        ds = CRUTSInferenceDataset(
            ds_path=str(root / "cru_ts4.05.1901.2020.tmp.dat.nc"),
            elevation_file=str(root / "elevation.tif"),
            land_mask_file=str(root / "land_mask.tif"),
            generator_type="esrgan",
            scaling_factor=scale,
        )
        print(f"# globe set-up (data + dataset): {time.perf_counter() - t0:.3f} s, "
              f"land fraction {ds.mask_np.mean():.4f}")
        model = seeded_esrgan(device, dtype, nf, nb, gc)

        def sweep(name):
            t = time.perf_counter()
            paths = inference_on_full_images(
                model, ds, str(root / name / "tmp"), "esrgan", batch_size=8,
                tile_size=tile_size, tile_overlap=tile_overlap, device=device,
            )
            return paths, time.perf_counter() - t

        fused_rdb.launches = 0
        paths, seconds = sweep("kernel")
        launches = fused_rdb.launches
        _, warm_seconds = sweep("kernel_warm")
        if device.type == "cuda":
            device_breakdown(lambda: sweep("profiled"))
        with plain_rdb():
            ref_paths, plain_seconds = sweep("plain")

        mask = ds.mask_np
        worst = 0.0
        if len(paths) != months:
            raise AssertionError(f"expected {months} GeoTIFFs, got {len(paths)}")
        for i, (p, rp) in enumerate(zip(paths, ref_paths)):
            arr, _ = read_geotiff(p)
            ref, _ = read_geotiff(rp)
            if arr.shape != (h * scale, w * scale):
                raise AssertionError(f"{p}: shape {arr.shape}")
            if not (np.isfinite(arr[mask]).all() and np.isnan(arr[~mask]).all()):
                raise AssertionError(f"{p}: not finite on land and NaN on ocean")
            item = ds[i]
            half_range = (float(item["max"]) - float(item["min"])) / 2
            # both readbacks quantize to 12 bits: a code step apart, plus the
            # bf16 kernel/plain difference, in the normalized [-1, 1] domain
            err = float(np.max(np.abs(arr[mask] - ref[mask]))) / half_range
            worst = max(worst, err)
        tol = 2 * MAX_ABS_ERR + GENERATOR_TOL[dtype]
        print(f"# globe: {months} months {h}x{w} -> {h * scale}x{w * scale}: worst normalized "
              f"|kernel - plain| {worst:.3e} (tol {tol:.3e}); {launches} RDB launches")
        if not (worst <= tol):
            raise AssertionError(f"whole-globe outputs disagree with the plain path ({worst:.3e})")
        return dict(launches=launches, seconds=seconds, warm_seconds=warm_seconds,
                    plain_seconds=plain_seconds, months=months)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from climsr_tpu_torch.ops import cuda_lib, rdb
    except ImportError as e:
        print(f"chip_smoke: the climsr_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda")

    # 1. environment
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"# card: {card}")

    # 2. build
    t0 = time.perf_counter()
    libs = cuda_lib.build({"climsr_rdb": rdb._SOURCES})
    print(f"# built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.3f} s")
    for line in libs["climsr_rdb"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   ptxas: {line.strip()}")

    # 3. kernel against its plain version
    kernel = phase_kernel(device)

    # 4. the full-width generator
    phase_generator(device)

    # 5. end to end
    globe = phase_globe(device)
    expected = 3 * NB * 14  # 8 months x 28 tiles = 224 tiles = 14 calls of 16
    if globe["launches"] != expected:
        raise AssertionError(f"whole-globe sweep: expected {expected} RDB launches, counted {globe['launches']}")
    print(f"# globe sweep: {globe['months'] / globe['seconds']:.4f} months/s first sweep, "
          f"{globe['months'] / globe['warm_seconds']:.4f} months/s second sweep, "
          f"{globe['months'] / globe['plain_seconds']:.4f} months/s with the plain RDB ({card})")

    # 6. results
    print(json.dumps({"kernels": [{
        "name": "fused_rdb",
        "route": "cuda",
        "source": "climsr_tpu_torch/csrc/rdb_fwd.cu",
        "replaces": "climsr_tpu/ops/pallas/rdb.py:190",
        "launches": globe["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
