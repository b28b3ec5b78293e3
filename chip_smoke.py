#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch/H100 port's main paths on one card and check them.

Two paths of ``climsr_tpu_torch`` at the flagship width (nf=64, nb=11, gc=16,
one output channel, bf16):

- inference: the ESRGAN tiled whole-globe sweep, CRU-TS months of 360x720 LR
  cut into 128-px tiles with 8-px overlap, 16 tiles per generator call,
  feather blend, land gather, 12-bit packed readback and one GeoTIFF per
  month. Kernel A, the fused residual dense block (``csrc/rdb_fwd.cu``), runs
  33 times per generator call;
- pixel-loss pre-training: ``create_generator(train=True)`` ->
  ``build_optimizer`` (AdamW, one-cycle) -> ``make_pretrain_step`` at batch
  192 (LR 32x32, HR 128x128), then ``make_eval_step``. Each step runs kernel
  B1 (the RDB forward that saves its features, ``csrc/rdb_fwd.cu``) and B2
  (the RDB backward, ``csrc/rdb_bwd.cu``) 33 times each and kernel C (the
  fusion head's input gradient to channel 0, ``csrc/conv9_dx_c0.cu``) once;
  the eval step runs A 33 times.

Phases (each raises on failure; nothing is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for the comparisons,
2. build: the three kernel libraries from ``climsr_tpu_torch/csrc``, one
   ``nvcc`` each, started together; ptxas registers and spills,
3. kernel A against its plain version at the inference shape (16 x 64 x
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
6. kernels B1 and B2 against their plain versions at the training shape
   (192 x 64 x 32 x 32) and a ragged one (3 x 64 x 29 x 45), bf16 and f32,
   with scales (0.2, 1) and, with x0, (0.04, 0.2): out, feat, dx, every dW
   and db; kernel C at 192 x 64 x 128 x 128 and 2 x 64 x 45 x 91; times
   beside the bounds (and C's library conv),
7. pre-training at full width: 6 steps through the kernels and 6 through
   the plain versions from the same seeded init and batch; losses and
   grad norms compared; exactly 33 B1 + 33 B2 + 1 C launches per step and no
   A; ms/step, samples/s, a profiled step; then one eval step (33 A
   launches, 16 finite metrics),
8. one JSON line with every kernel, the card line, then the device line as
   the last line.

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

# B1/B2 against their plain versions, max |kernel - plain| / max |plain| per
# output. f32: summation order only (dW sums 196,608 pixels in another order).
# bf16: both sides round dz to bf16 before the products read it, but a sum
# that lands on the other side of a rounding boundary moves that dz by one
# bf16 step (2^-8 relative) and the difference carries down the chain; the
# growth db sums dz after that rounding in the kernel and before it in the
# plain version (as in the TPU kernel).
TRAIN_KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# kernel C: the same bf16 inputs and f32 sums on both sides; the output is
# rounded once (2^-8 relative) after sums in another order
HEAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# pre-training through the kernels against the plain versions (bf16): the
# per-block differences above through 33 blocks, the head and 6 AdamW steps
STEP_LOSS_TOL, STEP_GRAD_NORM_TOL, TRAJECTORY_TOL = 1e-2, 5e-2, 2e-2

NF, NB, GC = 64, 11, 16
TRAIN_N, TRAIN_LR = 192, 32
STEPS = 6


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


def rdb_macs_per_px(nf=NF, gc=GC) -> int:
    return 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)


def bound(flops: float, moved: float, dtype) -> tuple:
    """(ms, "operations"|"bytes"): the least time on an H100, the larger of
    the operations over the peak rate of ``dtype`` and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rdb_bound_ms(x: torch.Tensor, with_x0: bool, nf=NF, gc=GC):
    """Kernel A's bound: its operations, and x, x0, out once and the packed f32 weights."""
    n, _, h, w = x.shape
    weight_bytes = 4 * (rdb_macs_per_px(nf, gc) + 4 * gc + nf)
    moved = x.numel() * x.element_size() * (3 if with_x0 else 2) + weight_bytes
    return bound(2.0 * rdb_macs_per_px(nf, gc) * n * h * w, moved, x.dtype)


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


def device_breakdown(run, top: int = 6, what: str = "sweep") -> None:
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
    print(f"# profiled {what}: {wall_us / 1e6:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
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



def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    abs_err = (got.float() - ref.float()).abs().max().item()
    return abs_err, abs_err / max(ref.float().abs().max().item(), 1e-30)


def phase_train_kernels(device) -> dict:
    """Kernels B1 and B2 against rdb_fwd_save_reference / rdb_bwd_reference."""
    from climsr_tpu_torch.ops.rdb import (
        fused_rdb_bwd, fused_rdb_fwd_save, pack_rdb_weights, rdb_bwd_reference, rdb_fwd_save_reference,
    )

    result = {}
    for n, h, w in ((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45)):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TRAIN_KERNEL_TOL[dtype]
            x, x0, weights = rdb_inputs(n, h, w, dtype, device)
            packed = pack_rdb_weights(weights, dtype)
            gen = torch.Generator(device="cpu").manual_seed(2)
            g = (0.01 * torch.randn(n, NF, h, w, generator=gen)).to(device, dtype).contiguous(
                memory_format=torch.channels_last)  # an upstream gradient's scale
            for res, (gy, gx) in ((None, (0.2, 1.0)), (x0, (0.04, 0.2))):
                tag = f"{n}x{NF}x{h}x{w} {str(dtype)[6:]} x0={res is not None}"
                out, feat = fused_rdb_fwd_save(x, weights, res, packed)
                torch.cuda.synchronize()
                ref_out, ref_feat = rdb_fwd_save_reference(x, weights, res)
                checks = {"out": rel_err(out, ref_out), "feat": rel_err(feat, ref_feat)}
                dx, dws, dbs = fused_rdb_bwd(feat, g, weights, gy, gx)
                torch.cuda.synchronize()
                ref_dx, ref_dws, ref_dbs = rdb_bwd_reference(feat, g, weights, gy, gx)
                checks["dx"] = rel_err(dx, ref_dx)
                for k in range(5):
                    checks[f"dW{k + 1}"] = rel_err(dws[k], ref_dws[k])
                    checks[f"db{k + 1}"] = rel_err(dbs[k], ref_dbs[k])
                worst = max(r for _, r in checks.values())
                print(f"# B1/B2 {tag} (gy, gx)=({gy}, {gx}): relative err "
                      + ", ".join(f"{k} {r:.2e}" for k, (_, r) in checks.items()) + f" (tol {tol:g})")
                if not (worst <= tol):
                    raise AssertionError(f"B1/B2 {tag}: kernels disagree with the plain versions ({worst:.3e})")
                if (n, dtype, res) == (TRAIN_N, torch.bfloat16, None):
                    px = n * h * w
                    total = NF + 4 * GC
                    wbytes = 4 * rdb_macs_per_px() + 4 * (4 * GC + NF)
                    fwd_bytes = px * 2 * (2 * NF + total) + wbytes
                    bwd_bytes = px * 2 * (total + 2 * NF) + wbytes
                    b1_bound = bound(2.0 * rdb_macs_per_px() * px, fwd_bytes, dtype)
                    b2_bound = bound(4.0 * rdb_macs_per_px() * px, bwd_bytes, dtype)
                    result["fused_rdb_fwd_save"] = dict(
                        max_abs_err=max(checks["out"][0], checks["feat"][0]),
                        ms=cuda_ms(lambda: fused_rdb_fwd_save(x, weights, None, packed)),
                        plain_ms=cuda_ms(lambda: rdb_fwd_save_reference(x, weights, None)),
                        bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None)
                    result["fused_rdb_bwd"] = dict(
                        max_abs_err=max(checks[k][0] for k in checks if k not in ("out", "feat")),
                        ms=cuda_ms(lambda: fused_rdb_bwd(feat, g, weights, gy, gx)),
                        plain_ms=cuda_ms(lambda: rdb_bwd_reference(feat, g, weights, gy, gx)),
                        bound_ms=b2_bound[0], bound_by=b2_bound[1], library_ms=None)
                    for name in ("fused_rdb_fwd_save", "fused_rdb_bwd"):
                        r = result[name]
                        print(f"# {name} {tag}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return result


def phase_head_kernel(device) -> dict:
    """Kernel C against conv9_dx_c0_reference, and the library's transposed conv."""
    import torch.nn.functional as F

    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, conv9_dx_c0_reference

    result = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n, h, w in ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, 64, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
            weight = ((torch.rand(64, 3, 9, 9, generator=gen) * 2 - 1) / (81 * 3) ** 0.5).to(device, dtype)
            got = conv9_dx_c0(g, weight)
            torch.cuda.synchronize()
            ref = conv9_dx_c0_reference(g, weight)
            abs_err, rel = rel_err(got, ref)
            tag = f"conv9_dx_c0 {n}x64x{h}x{w} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {HEAD_TOL[dtype]:g})")
            if got.shape != (n, 1, h, w) or not (rel <= HEAD_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with conv9_dx_c0_reference ({rel:.3e})")
            if (n, dtype) == (TRAIN_N, torch.bfloat16):
                px = n * h * w
                b = bound(2.0 * 81 * 64 * px, px * 2 * (64 + 1) + 4 * 81 * 64, dtype)
                w0 = weight[:, :1].contiguous()
                result = dict(
                    max_abs_err=abs_err, ms=cuda_ms(lambda: conv9_dx_c0(g, weight)),
                    plain_ms=cuda_ms(lambda: conv9_dx_c0_reference(g, weight)),
                    bound_ms=b[0], bound_by=b[1],
                    library_ms=cuda_ms(lambda: F.conv_transpose2d(g, w0, padding=4)))
                print(f"# {tag}: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
                      f"library conv_transpose2d {result['library_ms']:.4f} ms, "
                      f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
    return result


@contextlib.contextmanager
def plain_training():
    """Run FusedRDB and the fusion head's backward through the plain versions."""
    from climsr_tpu_torch.ops import head_bwd, rdb

    saved = rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd, head_bwd.conv9_dx_c0
    rdb.fused_rdb_fwd_save = lambda x, weights, x0=None, packed=None: rdb.rdb_fwd_save_reference(x, weights, x0)
    rdb.fused_rdb_bwd = rdb.rdb_bwd_reference
    head_bwd.conv9_dx_c0 = head_bwd.conv9_dx_c0_reference
    try:
        yield
    finally:
        rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd, head_bwd.conv9_dx_c0 = saved


def train_batch(n=TRAIN_N, lr=TRAIN_LR, scale=4) -> dict:
    """A seeded NCHW batch: LR (climate, elevation, mask) and an HR target that
    the generator can learn (the nearest-upsampled climate channel plus noise)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(n, 3, lr, lr, generator=gen)
    hr = torch.repeat_interleave(torch.repeat_interleave(x[:, :1], scale, 2), scale, 3)
    hr = (hr + 0.1 * torch.randn(hr.shape, generator=gen)).clamp(-1, 1)
    elev = torch.randn(n, 1, lr * scale, lr * scale, generator=gen)
    mask = (torch.rand(n, 1, lr * scale, lr * scale, generator=gen) > 0.3).float()
    return {"lr": x, "hr": hr, "elevation": elev, "mask": mask,
            "min": torch.full((n,), -30.0), "max": torch.full((n,), 40.0), "original_data": 35.0 * hr + 5.0}


def phase_pretrain(device) -> dict:
    """Full-width pre-training through the kernels and through the plain versions."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig, SchedulerConfig
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.schedules import resolve_momentum_schedule, resolve_schedule
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step, make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState
    from climsr_tpu_torch.models import create_generator

    batch = {k: v.to(device) for k, v in train_batch().items()}
    lr = 1e-4
    sched = SchedulerConfig(name="one_cycle_schedule", max_lr=lr, num_training_steps=STEPS)
    counters = (fused_rdb_fwd_save, fused_rdb_bwd, conv9_dx_c0, fused_rdb)

    def run(tag: str):
        model = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                                 device=device, train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
        tx = build_optimizer(OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4),
                             resolve_schedule(sched, lr, STEPS), b1_schedule=resolve_momentum_schedule(sched, STEPS),
                             device=device)
        state = TrainState.create(model, tx)
        step = make_pretrain_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
        losses, norms, times = [], [], []
        for c in counters:
            c.launches = 0
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["train/loss"].item())
            norms.append(metrics["grad_norm"].item())
            times.append(time.perf_counter() - t)
        launches = [c.launches for c in counters]
        ms = 1e3 * statistics.median(times[1:])
        print(f"# pre-training {tag}: losses {['%.6f' % v for v in losses]}, grad norms "
              f"{['%.6f' % v for v in norms]}, {ms:.3f} ms/step (median of steps 2-{STEPS}), "
              f"{TRAIN_N / ms * 1e3:.2f} samples/s; launches B1 {launches[0]}, B2 {launches[1]}, "
              f"C {launches[2]}, A {launches[3]}")
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"pre-training {tag}: non-finite loss or grad norm")
        return model, state, step, losses, norms, ms, launches

    model, state, step, losses, norms, ms, launches = run("through the kernels")
    expected = [3 * NB * STEPS, 3 * NB * STEPS, STEPS, 0]
    if launches != expected:
        raise AssertionError(f"pre-training: expected launches B1, B2, C, A = {expected}, counted {launches}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"pre-training: the loss did not decrease ({losses[0]} -> {losses[-1]})")
    device_breakdown(lambda: step(state, batch), what="pre-training step")
    with plain_training():
        *_, plain_losses, plain_norms, plain_ms, _ = run("through the plain versions")
    loss_err = abs(losses[0] - plain_losses[0]) / abs(plain_losses[0])
    norm_err = abs(norms[0] - plain_norms[0]) / abs(plain_norms[0])
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"# pre-training kernels vs plain: step-1 loss {loss_err:.2e} (tol {STEP_LOSS_TOL:g}), "
          f"step-1 grad norm {norm_err:.2e} (tol {STEP_GRAD_NORM_TOL:g}), loss trajectory {traj_err:.2e} "
          f"(tol {TRAJECTORY_TOL:g})")
    if not (loss_err <= STEP_LOSS_TOL and norm_err <= STEP_GRAD_NORM_TOL and traj_err <= TRAJECTORY_TOL):
        raise AssertionError("pre-training through the kernels disagrees with the plain versions")

    eval_step = make_eval_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
    fused_rdb.launches = 0
    metrics = eval_step(batch)
    a_launches = fused_rdb.launches
    bad = sorted(k for k, v in metrics.items() if not torch.isfinite(v).item())
    print(f"# eval step: {len(metrics) - 2} metrics + 2 losses, {a_launches} A launches; "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in sorted(metrics.items())))
    if len(metrics) != 18 or bad:
        raise AssertionError(f"eval step: expected 16 finite metrics and 2 losses, non-finite {bad}")
    if a_launches != 3 * NB:
        raise AssertionError(f"eval step: expected {3 * NB} A launches, counted {a_launches}")
    return dict(launches=dict(zip(("fused_rdb_fwd_save", "fused_rdb_bwd", "conv9_dx_c0"), launches)),
                ms=ms, plain_ms=plain_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from climsr_tpu_torch.ops import cuda_lib, head_bwd, rdb
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

    # 2. build, one nvcc per library, all at once
    t0 = time.perf_counter()
    libs = cuda_lib.build({"climsr_rdb": rdb._SOURCES, "climsr_rdb_bwd": rdb._BWD_SOURCES,
                           "climsr_head_bwd": head_bwd._SOURCES})
    print(f"# built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.3f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"#   ptxas {name}: {line.strip()}")

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

    # 6. the training kernels against their plain versions
    train_kernels = phase_train_kernels(device)
    train_kernels["conv9_dx_c0"] = phase_head_kernel(device)

    # 7. pre-training and an eval step at full width
    pretrain = phase_pretrain(device)
    print(f"# pre-training step, batch {TRAIN_N}: {pretrain['ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['ms'] * 1e3:.2f} samples/s) through the kernels, {pretrain['plain_ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['plain_ms'] * 1e3:.2f} samples/s) through the plain versions ({card})")

    # 8. results
    kernels = [dict(name="fused_rdb", route="cuda", source="climsr_tpu_torch/csrc/rdb_fwd.cu",
                    replaces="climsr_tpu/ops/pallas/rdb.py:190", launches=globe["launches"], library_ms=None,
                    **kernel)]
    for name, source, replaces in (
        ("fused_rdb_fwd_save", "climsr_tpu_torch/csrc/rdb_fwd.cu", "climsr_tpu/ops/pallas/rdb.py:315"),
        ("fused_rdb_bwd", "climsr_tpu_torch/csrc/rdb_bwd.cu", "climsr_tpu/ops/pallas/rdb.py:432"),
        ("conv9_dx_c0", "climsr_tpu_torch/csrc/conv9_dx_c0.cu", "climsr_tpu/ops/pallas/head_bwd.py:53"),
    ):
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=pretrain["launches"][name], **train_kernels[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
