#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch/H100 port's main paths on one card and check them.

The paths of ``climsr_tpu_torch`` at the flagship width (nf=64, nb=11,
gc=16, one output channel, bf16), pre-training and inference at the
reference defaults (``GeneratorConfig``: nf=64, nb=23, gc=32), and the entry
points of the three kernels that no model path runs:

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
  the eval step runs A 33 times;
- the relativistic GAN fine-tune: ``create_discriminator`` (ESRGAN
  discriminator, 8192-input fc1 at HR 128), ``build_perceptual_loss`` (VGG19
  to conv5_4 on seeded weights), Adam for G and D -> ``make_gan_step`` at
  batch 192, then ``make_gan_val_losses``. Each step runs B1 and B2 33 times
  each and C once; the val-loss call runs A 33 times;
- pre-training at the reference defaults: the same entry points at nf=64,
  nb=23, gc=32, batch 192. Each step runs B1 and B2 69 times each (the bf16
  chain at 8 x 16 tiles) and C once;
- training through the entry point a user calls (``cli.train.run`` from the
  composed ``esrgan_pre_training`` config) on a synthetic WorldClim set: the
  same kernels as pre-training (B1, B2, C per step) and A per validation or
  test batch;
- kernel D (``fused_rdb_nhwc``, the NHWC entry to kernel A), kernel E
  (``fused_hr_tail``, ``csrc/hr_tail.cu``) and kernel F (``dc0``, two
  variants, which launches kernel C, ``csrc/conv9_dx_c0.cu``, through the
  probe ``climsr_tpu_torch.scripts.bench_head_bwd_probe``). No model path
  runs them (as in the JAX package); each is driven through its own entry
  point.

Phases (each raises on failure; nothing is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for the comparisons,
2. build: the four kernel libraries from ``climsr_tpu_torch/csrc``, one
   ``nvcc`` each, started together; ptxas registers and spills,
3. kernel A against its plain version at the inference shape (16 x 64 x
   128 x 128) and a ragged one (2 x 64 x 45 x 91), with and without the
   folded residual, in bf16 and f32, at gc=16 and gc=32 (and gc=48 on the
   ragged shape), and at gc=16 on phase 13's eval batches (192 and 64 x 64 x
   32 x 32); times (CUDA events, medians) beside the bound at gc=16 and
   gc=32, in bf16,
4. the generator (seeded weights) on 16 tiles of 32x32 through the kernel
   and through the plain RDB, in bf16 and f32, at the flagship widths (33
   launches per forward) and at the reference defaults (69),
5. end to end: a synthetic globe (8 months of 360x720 NetCDF, 1440x2880
   elevation and land mask at 29% land) through ``CRUTSInferenceDataset`` and
   ``inference_on_full_images``; 8 GeoTIFFs, launches = 33 x 14 generator
   calls, outputs against the same sweep with the plain RDB; a third sweep
   under ``torch.profiler`` for the device's busy share and top kernels,
6. kernels B1 and B2 against their plain versions at the training shape
   (192 x 64 x 32 x 32) and a ragged one (3 x 64 x 29 x 45), bf16 and f32,
   with scales (0.2, 1) and, with x0, (0.04, 0.2): out, feat, dx, every dW
   and db, at gc=16 and gc=32 (and gc=48 on the ragged shape); at the
   training shape (gc=16 and gc=32) the times beside the bounds, B2's dX
   pass, dW pass, reduction and wrapper ops each timed on the device, and
   two B2 calls on the same inputs bitwise equal; kernel C at 192 x 64 x
   128 x 128 and 2 x 64 x 45 x 91;
   times beside the bounds (and C's library conv), two C calls bitwise equal,
7. pre-training at full width: 6 steps through the kernels and 6 through
   the plain versions from the same seeded init and batch; losses and
   grad norms compared; exactly 33 B1 + 33 B2 + 1 C launches per step and no
   A; ms/step, samples/s, a profiled step (with the device time of every
   kernel inside the fusion head's backward, ``FusionConv1``: kernel C and the
   wrapper's own ops); then one eval step (33 A launches, 16 finite metrics),
8. kernels D, E and F against their plain versions, bf16 and f32: D at
   192 x 64 x 32 x 32 and 3 x 64 x 29 x 45 (also at gc=32), E and F (C's
   kernel) at 192 x 64 x 128 x 128 and 2 x 64 x 45 x 91; times beside the
   bounds; E also at the sweep's HR
   head, 16 x 64 x 512 x 512 bf16, timed against its plain version (cuDNN's
   two convs) and not listed; two E calls bitwise equal. Then D's and E's own
   paths, counted: the flagship generator's first RRDB through D (three
   launches) and its HR tail through E (one launch), each against the
   generator's own modules,
9. the probe (``bench_head_bwd_probe.probe``): F1 and F2 (C's kernel through
   F's entry) checked and timed against kernel C, the plain version and the
   library's transposed conv; F launches no C count,
10. the GAN fine-tune at full width: 4 steps through the kernels and 4
   through the plain versions from the same seeded init and batch; loss_G
   and loss_D compared step by step; exactly 33 B1 + 33 B2 + 1 C launches
   per step and no A, D, E or F; ms/step, samples/s, a profiled step; then
   one val-loss call (33 A launches, finite losses),
11. pre-training at the reference defaults (nf=64, nb=23, gc=32): 4 steps
   through the kernels and 4 through the plain versions from the same seeded
   init and batch, compared as in phase 7; exactly 69 B1 + 69 B2 + 1 C
   launches per step and no A; ms/step with the card line,
12. the kernels A, B1, B2 and D at gc=32: time, plain time, bound and error
   printed with the card line (the JSON line carries gc=16's),
13. the training entry point end to end, as a user runs it: a synthetic
   WorldClim set (``make_synthetic_dataset``, 128/64/64 tiles per stage and
   temperature variable, its tables handed over without feather files),
   ``compose(... "experiment=esrgan_pre_training" ...)`` (nf=64, nb=11, gc=16,
   batch 192, bf16) and ``cli.train.run`` with the datamodule: the tile store
   on the card, device augmentation, 2 epochs of 2 steps, a validation each
   epoch, three test sets, checkpoints and the simple profiler's stage
   table. Exactly 33 B1 + 33 B2 + 1 C per step and 33 A per eval batch; the
   same run through the plain versions (kernel A too) from the same seed,
   per-step train/loss and val/rmse compared; the best checkpoint re-validated
   in a fresh generator and the latest one against the trained model on 16
   tiles; the trained generator on a validation batch of 192 and of 64
   through kernel A and through the plain RDB; the trainer's samples/s
   beside phase 7's bare step,
14. one JSON line with every kernel (the launches of A, B1, B2 and C are
   phase 13's, and A's times, bound and error are per launch over phase 13's
   eval shapes, from phase 3), the card line, then the device line as the
   last line.

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
# kernel D is kernel A reached through the NHWC entry: KERNEL_TOL. Kernel E:
# f32 differs by summation order only; in bf16 both sides read the same
# rounded lrelu(x) and weights and sum in f32, but the plain version's cuDNN
# conv rounds HRconv's sum to bf16 before the bias add and the lrelu, where the
# kernel rounds once after them, so a hidden value can move by one bf16 step
# (2^-8 relative) before conv_last sums 576 of them: KERNEL_TOL as for A.
# Kernel F computes C's function from the same bf16 inputs with f32 sums:
# HEAD_TOL.
TAIL_TOL = KERNEL_TOL
# D's and E's own paths against the generator's own modules (bf16): D's path
# adds RDB3's outer residual in bf16 after the kernel's rounding, where the
# generator folds it into kernel A's single write: two roundings, not one
PATH_TOL = {torch.bfloat16: 2e-2}
# the GAN fine-tune through the kernels against the plain versions (bf16),
# loss_G and loss_D at each of 4 Adam steps: the generator's per-block
# differences above, through the discriminator, VGG19 and the Adam updates
GAN_LOSS_TOL = 2e-2
GAN_STEPS = 4

NF, NB, GC = 64, 11, 16
NB_REF, GC_REF = 23, 32  # GeneratorConfig's defaults (with nf=64): the reference's own widths
TRAIN_N, TRAIN_LR = 192, 32
STEPS = 6
REF_STEPS = 4  # phase 11's steps through the kernels and through the plain versions
# phase 13: synthetic tiles per stage (train, val, test) and temperature variable,
# 2 steps of 192 an epoch, one validation batch, three test sets
TRAINER_TILES, TRAINER_EPOCHS = (128, 64, 64), 2
# kernel A's shapes there: the validation set (3 x 64 tiles) in one batch of
# 192, each test set in one of 64
EVAL_SHAPES = ((TRAIN_N, TRAIN_LR, TRAIN_LR), (TRAINER_TILES[2], TRAIN_LR, TRAIN_LR))


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


def phase_kernel(device, gc=GC, shapes=((16, 128, 128), (2, 45, 91)), timed=((16, 128, 128),)) -> dict:
    """Kernel A at growth width ``gc`` against rdb_reference at each of
    ``shapes``; returns {((n, h, w), with x0): numbers} for the bf16 cases of
    the shapes in ``timed``, which are also timed."""
    from climsr_tpu_torch.ops.rdb import fused_rdb, pack_rdb_weights, rdb_reference

    result = {}
    for n, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, x0, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            packed = pack_rdb_weights(weights, dtype)
            for res in (None, x0):
                got = fused_rdb(x, weights, res, packed)
                torch.cuda.synchronize()
                ref = rdb_reference(x, weights, res)
                abs_err = (got.float() - ref.float()).abs().max().item()
                rel = abs_err / ref.float().abs().max().item()
                tag = f"fused_rdb {n}x{NF}x{h}x{w} gc={gc} {str(dtype)[6:]} x0={res is not None}"
                print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {KERNEL_TOL[dtype]:g})")
                if not (rel <= KERNEL_TOL[dtype]):
                    raise AssertionError(f"{tag}: kernel disagrees with rdb_reference ({rel:.3e})")
                if (n, h, w) in timed and dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: fused_rdb(x, weights, res, packed))
                    plain = cuda_ms(lambda: rdb_reference(x, weights, res))
                    bound, bound_by = rdb_bound_ms(x, res is not None, gc=gc)
                    print(f"# {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                          f"bound {bound:.4f} ms ({bound_by})")
                    result[(n, h, w), res is not None] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain,
                                                              bound_ms=bound, bound_by=bound_by)
    return result


def launch_mean(rows: list) -> dict:
    """Kernel A's numbers per launch over a path's launches (one row each):
    the times and bound averaged, the largest error."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {k: sum(r[k] for r in rows) / len(rows) for k in keys}
    by = [r["bound_by"] for r in rows]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), bound_by=max(set(by), key=by.count), **out)


def device_breakdown(run, top: int = 6, what: str = "sweep", under: str = "") -> list:
    """Run ``run()`` under ``torch.profiler`` and print the device's busy share
    of the wall time and the kernels that take the most device time; returns
    the device rows of ``key_averages()``. With ``under``, also print the
    device time of every kernel launched inside the CPU ops whose name
    contains it (an autograd node's backward, say), by kernel."""
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
    if under:
        inside = {}

        def walk(e):
            for k in e.kernels:
                inside[k.name] = inside.get(k.name, 0.0) + k.duration / 1e3
            for c in e.cpu_children:
                walk(c)

        for e in prof.events():
            if under in e.name and not (e.cpu_parent is not None and under in e.cpu_parent.name):
                walk(e)
        print(f"# device ms inside {under} ({len(inside)} kernels; none means the trace did not link them):")
        for name, ms in sorted(inside.items(), key=lambda kv: -kv[1]):
            print(f"#   {ms:10.4f} ms  {name[:100]}")
    return kernels


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


def assert_bitwise_repeatable(tag: str, run) -> None:
    """Two calls of ``run()`` on the same inputs give bitwise-equal bf16 outputs, or raise."""
    first, second = run(), run()
    torch.cuda.synchronize()
    same = torch.equal(first.view(torch.int16), second.view(torch.int16))
    print(f"# {tag}: two calls on the same inputs give bitwise-equal outputs: {same}")
    if not same:
        raise AssertionError(f"{tag} is not deterministic: two calls differ")


def phase_train_kernels(device, gc=GC, shapes=((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45))) -> dict:
    """Kernels B1 and B2 at growth width ``gc`` against rdb_fwd_save_reference /
    rdb_bwd_reference; times, bounds and B2's repeatability at the training shape."""
    from climsr_tpu_torch.ops.rdb import (
        fused_rdb_bwd, fused_rdb_fwd_save, pack_rdb_weights, rdb_bwd_reference, rdb_fwd_save_reference,
    )

    result = {}
    for n, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = TRAIN_KERNEL_TOL[dtype]
            x, x0, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            packed = pack_rdb_weights(weights, dtype)
            gen = torch.Generator(device="cpu").manual_seed(2)
            g = (0.01 * torch.randn(n, NF, h, w, generator=gen)).to(device, dtype).contiguous(
                memory_format=torch.channels_last)  # an upstream gradient's scale
            for res, (gy, gx) in ((None, (0.2, 1.0)), (x0, (0.04, 0.2))):
                tag = f"{n}x{NF}x{h}x{w} gc={gc} {str(dtype)[6:]} x0={res is not None}"
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
                    total = NF + 4 * gc
                    macs = rdb_macs_per_px(gc=gc)
                    wbytes = 4 * macs + 4 * (4 * gc + NF)
                    fwd_bytes = px * 2 * (2 * NF + total) + wbytes
                    bwd_bytes = px * 2 * (total + 2 * NF) + wbytes
                    b1_bound = bound(2.0 * macs * px, fwd_bytes, dtype)
                    b2_bound = bound(4.0 * macs * px, bwd_bytes, dtype)
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
                    passes = b2_passes(lambda: fused_rdb_bwd(feat, g, weights, gy, gx))
                    print(f"# fused_rdb_bwd {tag} device ms per call: "
                          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
                    again = fused_rdb_bwd(feat, g, weights, gy, gx)
                    torch.cuda.synchronize()
                    first = [dx, *dws, *dbs]
                    second = [again[0], *again[1], *again[2]]
                    same = all(torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))
                               for a, b in zip(first, second))
                    print(f"# fused_rdb_bwd {tag}: two calls on the same inputs give bitwise-equal dx, dW, db: {same}")
                    if not same:
                        raise AssertionError("fused_rdb_bwd is not deterministic: two calls differ")
    return result


def b2_passes(run, calls: int = 5) -> dict:
    """Device ms per call of kernel B2's parts, from :func:`device_breakdown`
    over ``calls`` calls: its dX pass, its dW pass, the fixed-order reduction
    and the wrapper's own device ops (weight packing, db_5)."""
    run()
    torch.cuda.synchronize()
    kernels = device_breakdown(lambda: [run() for _ in range(calls)], what=f"{calls} B2 calls")
    parts = dict.fromkeys(("dX", "dW", "reduce", "wrapper ops"), 0.0)
    wrapper = []
    for e in kernels:
        part = ("dX" if "rdb_bwd_dx" in e.key else "reduce" if "wgrad_reduce" in e.key
                else "dW" if "rdb_wgrad" in e.key else "wrapper ops")
        parts[part] += e.self_device_time_total / 1e3 / calls
        if part == "wrapper ops":
            wrapper.append(f"{e.self_device_time_total / 1e3 / calls:.4f} ms {e.key[:60]}")
    print("#   wrapper ops per call: " + "; ".join(wrapper))
    return parts


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
                assert_bitwise_repeatable(tag, lambda: conv9_dx_c0(g, weight))
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


def phase_pretrain(device, nb=NB, gc=GC, steps=STEPS) -> dict:
    """Pre-training at nf=64 and (nb, gc) through the kernels and through the
    plain versions, ``steps`` steps each, then an eval step."""
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
    sched = SchedulerConfig(name="one_cycle_schedule", max_lr=lr, num_training_steps=steps)
    widths = f"nf={NF} nb={nb} gc={gc}"
    counters = (fused_rdb_fwd_save, fused_rdb_bwd, conv9_dx_c0, fused_rdb)

    def run(tag: str):
        model = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                                 device=device, train=True, in_channels=3, out_channels=1, nf=NF, nb=nb, gc=gc)
        tx = build_optimizer(OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4),
                             resolve_schedule(sched, lr, steps), b1_schedule=resolve_momentum_schedule(sched, steps),
                             device=device)
        state = TrainState.create(model, tx)
        step = make_pretrain_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
        losses, norms, times = [], [], []
        for c in counters:
            c.launches = 0
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["train/loss"].item())
            norms.append(metrics["grad_norm"].item())
            times.append(time.perf_counter() - t)
        launches = [c.launches for c in counters]
        ms = 1e3 * statistics.median(times[1:])
        print(f"# pre-training {widths} {tag}: losses {['%.6f' % v for v in losses]}, grad norms "
              f"{['%.6f' % v for v in norms]}, {ms:.3f} ms/step (median of steps 2-{steps}), "
              f"{TRAIN_N / ms * 1e3:.2f} samples/s; launches B1 {launches[0]}, B2 {launches[1]}, "
              f"C {launches[2]}, A {launches[3]}")
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"pre-training {tag}: non-finite loss or grad norm")
        return model, state, step, losses, norms, ms, launches

    model, state, step, losses, norms, ms, launches = run("through the kernels")
    expected = [3 * nb * steps, 3 * nb * steps, steps, 0]
    if launches != expected:
        raise AssertionError(f"pre-training {widths}: expected launches B1, B2, C, A = {expected}, "
                             f"counted {launches}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"pre-training {widths}: the loss did not decrease ({losses[0]} -> {losses[-1]})")
    # the fusion head's backward: kernel C and the wrapper's other device ops
    device_breakdown(lambda: step(state, batch), what=f"pre-training step {widths}", under="FusionConv1Backward")
    with plain_training():
        *_, plain_losses, plain_norms, plain_ms, _ = run("through the plain versions")
    loss_err = abs(losses[0] - plain_losses[0]) / abs(plain_losses[0])
    norm_err = abs(norms[0] - plain_norms[0]) / abs(plain_norms[0])
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"# pre-training {widths} kernels vs plain: step-1 loss {loss_err:.2e} (tol {STEP_LOSS_TOL:g}), "
          f"step-1 grad norm {norm_err:.2e} (tol {STEP_GRAD_NORM_TOL:g}), loss trajectory {traj_err:.2e} "
          f"(tol {TRAJECTORY_TOL:g})")
    if not (loss_err <= STEP_LOSS_TOL and norm_err <= STEP_GRAD_NORM_TOL and traj_err <= TRAJECTORY_TOL):
        raise AssertionError(f"pre-training {widths} through the kernels disagrees with the plain versions")

    eval_step = make_eval_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
    fused_rdb.launches = 0
    metrics = eval_step(batch)
    a_launches = fused_rdb.launches
    bad = sorted(k for k, v in metrics.items() if not torch.isfinite(v).item())
    print(f"# eval step {widths}: {len(metrics) - 2} metrics + 2 losses, {a_launches} A launches; "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in sorted(metrics.items())))
    if len(metrics) != 18 or bad:
        raise AssertionError(f"eval step: expected 16 finite metrics and 2 losses, non-finite {bad}")
    if a_launches != 3 * nb:
        raise AssertionError(f"eval step: expected {3 * nb} A launches, counted {a_launches}")
    return dict(launches=dict(zip(("fused_rdb_fwd_save", "fused_rdb_bwd", "conv9_dx_c0"), launches)),
                ms=ms, plain_ms=plain_ms)


def phase_rdb_nhwc(device, gc=GC) -> dict:
    """Kernel D's entry, ``fused_rdb_nhwc`` (NHWC in and out, HWIO weights),
    at growth width ``gc`` against rdb_reference. Its timed call packs the
    weights, as the JAX ``fused_rdb`` takes raw ones."""
    from climsr_tpu_torch.ops.rdb import fused_rdb_nhwc, rdb_reference

    result = {}
    for n, h, w in ((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45)):
        for dtype in (torch.float32, torch.bfloat16):
            x, _, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            xn = x.permute(0, 2, 3, 1)  # the NHWC view of channels_last storage
            hwio = [t for wt, bs in weights for t in (wt.permute(2, 3, 1, 0), bs)]
            got = fused_rdb_nhwc(xn, *hwio)
            torch.cuda.synchronize()
            ref = rdb_reference(x, weights).permute(0, 2, 3, 1)
            abs_err, rel = rel_err(got, ref)
            tag = f"fused_rdb_nhwc {n}x{h}x{w}x{NF} gc={gc} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {TAIL_TOL[dtype]:g})")
            if got.shape != xn.shape or not (rel <= TAIL_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with rdb_reference ({rel:.3e})")
            if (n, dtype) == (TRAIN_N, torch.bfloat16):
                b = rdb_bound_ms(x, False, gc=gc)
                result = dict(max_abs_err=abs_err, ms=cuda_ms(lambda: fused_rdb_nhwc(xn, *hwio)),
                              plain_ms=cuda_ms(lambda: rdb_reference(x, weights)),
                              bound_ms=b[0], bound_by=b[1], library_ms=None)
                print(f"# {tag}: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
                      f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
    return result


def tail_inputs(n, h, w, dtype, device):
    """x (N, 64, H, W) channels_last and (whr, bhr, wcl, bcl) OIHW, from seed 0."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(n, NF, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
    bound = 1.0 / (9 * NF) ** 0.5
    shapes = ((NF, NF, 3, 3), (NF,), (1, NF, 3, 3), (1,))
    return x, [((torch.rand(s, generator=gen) * 2 - 1) * bound).to(device) for s in shapes]


def hr_tail_bound(x: torch.Tensor) -> tuple:
    """Kernel E's bound: HRconv 64 -> 64 and conv_last 64 -> 1, x and out once and the weights."""
    px = x.shape[0] * x.shape[2] * x.shape[3]
    flops = 2.0 * 9 * NF * (NF + 1) * px
    return bound(flops, px * 2 * (NF + 1) + 2 * 9 * NF * (NF + 1) + 4 * (NF + 1), x.dtype)


def phase_hr_tail(device) -> dict:
    """Kernel E against hr_tail_reference (the library's two cuDNN convs), at
    the training head's shape, a ragged one and, timed too but not listed,
    the sweep's HR head (16 tiles of 512 x 512)."""
    from climsr_tpu_torch.ops.head import fused_hr_tail, hr_tail_reference

    result = {}
    for n, h, w in ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91), (16, 512, 512)):
        for dtype in (torch.float32, torch.bfloat16) if n != 16 else (torch.bfloat16,):
            x, weights = tail_inputs(n, h, w, dtype, device)
            got = fused_hr_tail(x, *weights)
            torch.cuda.synchronize()
            ref = hr_tail_reference(x, weights)
            abs_err, rel = rel_err(got, ref)
            tag = f"fused_hr_tail {n}x{NF}x{h}x{w} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {TAIL_TOL[dtype]:g})")
            if got.shape != (n, 1, h, w) or not (rel <= TAIL_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with hr_tail_reference ({rel:.3e})")
            if dtype == torch.bfloat16 and n in (TRAIN_N, 16):
                b = hr_tail_bound(x)
                timed = dict(max_abs_err=abs_err, ms=cuda_ms(lambda: fused_hr_tail(x, *weights)),
                             plain_ms=cuda_ms(lambda: hr_tail_reference(x, weights)),
                             bound_ms=b[0], bound_by=b[1], library_ms=None)
                print(f"# {tag}: kernel {timed['ms']:.4f} ms, plain (cuDNN's two convs) {timed['plain_ms']:.4f} ms, "
                      f"bound {timed['bound_ms']:.4f} ms ({timed['bound_by']})")
                assert_bitwise_repeatable(tag, lambda: fused_hr_tail(x, *weights))
                if n == TRAIN_N:
                    result = timed
    return result


def phase_dc0(device) -> None:
    """Kernel F, both variants, against dc0_reference (the probe times them);
    each call launches kernel C, counted as F's and not as C's."""
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0, dc0_reference

    before = dc0.launches, conv9_dx_c0.launches
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n, h, w in ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, 64, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
            w1c0 = ((torch.rand(9, 9, 64, generator=gen) * 2 - 1) / 72).to(device)
            ref = dc0_reference(g, w1c0)
            for variant in ("flat", "dyfac"):
                got = dc0(g, w1c0, variant)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, ref)
                tag = f"dc0 {variant} {n}x64x{h}x{w} {str(dtype)[6:]}"
                print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {HEAD_TOL[dtype]:g})")
                if got.shape != (n, 1, h, w) or not (rel <= HEAD_TOL[dtype]):
                    raise AssertionError(f"{tag}: kernel disagrees with dc0_reference ({rel:.3e})")
    counted = dc0.launches - before[0], conv9_dx_c0.launches - before[1]
    print(f"# dc0: {counted[0]} F launches (kernel C's kernel), {counted[1]} counted as C")
    if counted != (8, 0):
        raise AssertionError(f"dc0: expected 8 F launches and 0 C launches, counted {counted}")


def path_rdb_nhwc_and_hr_tail(device) -> dict:
    """D's and E's own paths, their counts reset just before and read just
    after: the flagship generator's first RRDB (x + 0.2 * RDB3(RDB2(RDB1(x))))
    through ``fused_rdb_nhwc`` in NHWC, and its HR tail (lrelu, HRconv, lrelu,
    conv_last) through ``fused_hr_tail`` on its upconv2 output, each against
    the generator's own modules on the training batch's LR input (bf16)."""
    from climsr_tpu_torch.models.common import leaky_relu
    from climsr_tpu_torch.ops import head, rdb
    from climsr_tpu_torch.ops.fused_upsample_conv import nearest_up2_conv3

    dtype = torch.bfloat16
    model = seeded_esrgan(device, dtype)
    lr = train_batch()["lr"].to(device, dtype).contiguous(memory_format=torch.channels_last)
    launches = {}
    with torch.inference_mode():
        fea = model.conv_first(lr).contiguous(memory_format=torch.channels_last)
        rrdb = model.RRDB_trunk[0]
        want = rrdb(fea).permute(0, 2, 3, 1)
        rdb.fused_rdb_nhwc.launches = 0
        y = fea.permute(0, 2, 3, 1)
        for block in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            y = rdb.fused_rdb_nhwc(y, *(t for wt, bs in block.weights() for t in (wt.permute(2, 3, 1, 0), bs)))
        got = fea.permute(0, 2, 3, 1) + 0.2 * y
        launches["fused_rdb_nhwc"] = rdb.fused_rdb_nhwc.launches
        checks = {"fused_rdb_nhwc (first RRDB)": rel_err(got, want)}

        trunk = fea + model.trunk_conv(model.RRDB_trunk(fea))
        up = leaky_relu(nearest_up2_conv3(trunk, model.upconv1.weight, model.upconv1.bias))
        pre = nearest_up2_conv3(up, model.upconv2.weight, model.upconv2.bias)
        want = model.conv_last(leaky_relu(model.HRconv(leaky_relu(pre))))
        head.fused_hr_tail.launches = 0
        got = head.fused_hr_tail(pre.contiguous(memory_format=torch.channels_last), model.HRconv.weight,
                                 model.HRconv.bias, model.conv_last.weight, model.conv_last.bias)
        launches["fused_hr_tail"] = head.fused_hr_tail.launches
        checks[f"fused_hr_tail (HR head {tuple(pre.shape)})"] = rel_err(got, want)
    for tag, (abs_err, rel) in checks.items():
        print(f"# own path {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} against the generator's "
              f"modules (tol {PATH_TOL[dtype]:g})")
        if not (rel <= PATH_TOL[dtype]):
            raise AssertionError(f"{tag} disagrees with the generator's own modules ({rel:.3e})")
    print(f"# own paths: launches {launches}")
    if launches != {"fused_rdb_nhwc": 3, "fused_hr_tail": 1}:
        raise AssertionError(f"D's and E's own paths: expected 3 and 1 launches, counted {launches}")
    return launches


def phase_probe(device) -> dict:
    """The probe's own path: F1 and F2 checked and timed, their counts reset
    just before and read just after. Returns F1's and F2's numbers."""
    from climsr_tpu_torch.ops.head_bwd import dc0
    from climsr_tpu_torch.scripts import bench_head_bwd_probe as probe_mod

    dc0.launches = 0
    dc0.variant_launches.update(dict.fromkeys(dc0.variant_launches, 0))
    res = probe_mod.probe(device)
    launches = dict(dc0.variant_launches)
    px = probe_mod.B * probe_mod.H * probe_mod.W
    b = bound(2.0 * 81 * probe_mod.C * px, px * 2 * (probe_mod.C + 1) + 4 * 81 * probe_mod.C, torch.bfloat16)
    out = {}
    for variant in ("flat", "dyfac"):
        r = res[f"dc0_{variant}"]
        out[f"dc0_{variant}"] = dict(
            launches=launches[variant], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=res["plain dc0_reference"]["ms"], bound_ms=b[0], bound_by=b[1],
            library_ms=res["library conv_transpose2d"]["ms"])
    print(f"# probe: launches {launches}; bound {b[0]:.4f} ms ({b[1]}); kernel C {res['kernel C conv9_dx_c0']['ms']:.4f} ms")
    if min(launches.values()) < 1:
        raise AssertionError(f"probe: a variant of kernel F was never launched ({launches})")
    return out


def phase_gan(device) -> dict:
    """The GAN fine-tune at full width through the kernels and through the plain versions."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
    from climsr_tpu_torch.models import create_discriminator, create_generator
    from climsr_tpu_torch.ops.head import fused_hr_tail
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save, fused_rdb_nhwc
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step, make_gan_val_losses
    from climsr_tpu_torch.training.train_state import GANTrainState

    batch = {k: v.to(device) for k, v in train_batch().items()}
    lr, dtype = 1e-4, torch.bfloat16
    perceptual = build_perceptual_loss(compute_dtype=dtype, cutoff="conv5_4", device=device)
    counters = (fused_rdb_fwd_save, fused_rdb_bwd, conv9_dx_c0, fused_rdb, fused_rdb_nhwc, fused_hr_tail, dc0)
    names = ("B1", "B2", "C", "A", "D", "E", "F")

    def run(tag: str):
        g = create_generator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(0), device=device,
                             train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
        d = create_discriminator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(1), device=device,
                                 train=True, in_channels=1, out_channels=64, hr_size=4 * TRAIN_LR)
        if d.classification[0].in_features != 8192:
            raise AssertionError(f"fc1 takes {d.classification[0].in_features} inputs, not 8192")

        def tx():
            return build_optimizer(OptimizerConfig(name="adam", lr=lr, weight_decay=1e-4), lambda s: lr,
                                   device=device)

        state = GANTrainState.create(g, tx(), d, tx())
        step = make_gan_step(g, d, "esrgan", perceptual_fn=perceptual, compute_dtype=dtype, device=device)
        trace, times = [], []
        for c in counters:
            c.launches = 0
        for _ in range(GAN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            trace.append({k: v.item() for k, v in metrics.items()})
            times.append(time.perf_counter() - t)
        launches = dict(zip(names, (c.launches for c in counters)))
        ms = 1e3 * statistics.median(times[1:])
        print(f"# GAN {tag}: loss_G {['%.6f' % m['train/loss_G'] for m in trace]}, loss_D "
              f"{['%.6f' % m['train/loss_D'] for m in trace]}; step 1 terms "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(trace[0].items()))
              + f"; {ms:.3f} ms/step (median of steps 2-{GAN_STEPS}), {TRAIN_N / ms * 1e3:.2f} samples/s; "
              f"launches {launches}")
        if not all(np.isfinite(v) for m in trace for v in m.values()):
            raise AssertionError(f"GAN {tag}: a non-finite loss")
        return g, d, state, step, trace, ms, launches

    g, d, state, step, trace, ms, launches = run("through the kernels")
    expected = dict(B1=3 * NB * GAN_STEPS, B2=3 * NB * GAN_STEPS, C=GAN_STEPS, A=0, D=0, E=0, F=0)
    if launches != expected:
        raise AssertionError(f"GAN: expected launches {expected}, counted {launches}")
    device_breakdown(lambda: step(state, batch), what="GAN step")
    with plain_training():
        *_, plain_trace, plain_ms, _ = run("through the plain versions")
    worst = 0.0
    for k in ("train/loss_G", "train/loss_D"):
        for a, b in zip(trace, plain_trace):
            worst = max(worst, abs(a[k] - b[k]) / abs(b[k]))
    print(f"# GAN kernels vs plain: worst relative difference of loss_G and loss_D over {GAN_STEPS} steps "
          f"{worst:.2e} (tol {GAN_LOSS_TOL:g})")
    if not (worst <= GAN_LOSS_TOL):
        raise AssertionError("the GAN step through the kernels disagrees with the plain versions")

    val = make_gan_val_losses(g, d, "esrgan", perceptual_fn=perceptual, compute_dtype=dtype, device=device)
    fused_rdb.launches = 0
    losses = val(batch)
    a_launches = fused_rdb.launches
    print(f"# GAN val losses: {a_launches} A launches; "
          + ", ".join(f"{k} {v.item():.6f}" for k, v in sorted(losses.items())))
    if len(losses) != 3 or not all(torch.isfinite(v).item() for v in losses.values()):
        raise AssertionError(f"GAN val losses: expected 3 finite losses, got {losses}")
    if a_launches != 3 * NB:
        raise AssertionError(f"GAN val losses: expected {3 * NB} A launches, counted {a_launches}")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms)


def metric_rows(path: Path) -> list:
    """metrics.csv (a header row before each block of rows) -> [{column: float}]."""
    rows, header = [], None
    for line in path.read_text().splitlines():
        cells = line.split(",")
        if cells[0] == "step":
            header = cells
        else:
            rows.append({k: float(v) for k, v in zip(header, cells)})
    return rows


def phase_trainer(device, step_ms: float, card: str) -> dict:
    """The training entry point end to end: the composed ``esrgan_pre_training``
    experiment through ``cli.train.run`` on a synthetic WorldClim set (tiles on
    the card, device augmentation), through the kernels and then through the
    plain versions from the same seed; the best checkpoint read back."""
    from climsr_tpu_torch.cli.train import run
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.config.schemas import SuperResolutionDataConfig, from_dict
    from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule
    from climsr_tpu_torch.data.pipeline import DataLoader, build_eval_device_store, device_prefetch, gather
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import apply_generator_batch, create_generator
    from climsr_tpu_torch.ops.head import fused_hr_tail
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save, fused_rdb_nhwc
    from climsr_tpu_torch.training import loop
    from climsr_tpu_torch.training.checkpoint import CheckpointManager
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step

    counters = dict(A=fused_rdb, B1=fused_rdb_fwd_save, B2=fused_rdb_bwd, C=conv9_dx_c0, D=fused_rdb_nhwc,
                    E=fused_hr_tail, F=dc0)
    trained = []
    close = loop.Trainer.close

    def keep_model(self):  # the trained generator, for the checkpoint check below
        trained.append(self.g_model)
        close(self)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        tables = make_synthetic_dataset(root / "ds", n_tiles_per_stage=TRAINER_TILES, seed=0, write_index=False)
        data_s = time.perf_counter() - t

        def fit(tag: str):
            cfg = compose(default_config_dir(), "config", [
                "experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                f"trainer.max_epochs={TRAINER_EPOCHS}", "trainer.log_every_n_steps=1", "profiler=simple",
                "logger=csv", "print_config=false", f"training.output_dir={root / tag}",
            ])
            data_cfg = from_dict(SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
            dm = SuperResolutionDataModule(data_cfg, tables=tables)
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.Trainer.close = keep_model
            try:
                hp = run(cfg, datamodule=dm, device=device)
            finally:
                loop.Trainer.close = close
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            (run_dir,) = (root / tag / "outputs" / "runs" / "esrgan").iterdir()
            rows = metric_rows(run_dir / "metrics.csv")
            train = [r for r in rows if "train/loss" in r]
            val = [r for r in rows if "val/rmse" in r]
            print(f"# trainer {tag}: {wall:.3f} s for fit + test, hp_metric {hp:.6f}; train/loss "
                  f"{['%.6f' % r['train/loss'] for r in train]}, val/rmse {['%.6f' % r['val/rmse'] for r in val]}, "
                  f"train/samples_per_sec {['%.2f' % r['train/samples_per_sec'] for r in train]}; launches {launches}")
            for line in (run_dir / "profile_stages.txt").read_text().splitlines():
                print(f"#   stage {line.strip()}")
            return cfg, dm, run_dir, train, val, launches, wall

        cfg, dm, run_dir, train, val, launches, wall = fit("kernels")
        cfg_ = cfg["datamodule"]["cfg"]
        n_train, bs, vbs = 3 * TRAINER_TILES[0], cfg_["batch_size"], cfg_["validation_batch_size"]
        steps = TRAINER_EPOCHS * (n_train // bs)
        def sizes(n):  # the eval batches of a set of n tiles (a padded tail runs on its valid prefix)
            return [min(vbs, n - i) for i in range(0, n, vbs)]

        eval_sizes = TRAINER_EPOCHS * sizes(3 * TRAINER_TILES[1]) + 3 * sizes(TRAINER_TILES[2])
        eval_batches = len(eval_sizes)
        if {(n, TRAIN_LR, TRAIN_LR) for n in eval_sizes} != set(EVAL_SHAPES):
            raise AssertionError(f"trainer: eval batches {eval_sizes} are not kernel A's timed shapes {EVAL_SHAPES}")
        gen = cfg["generator"]
        nb = gen["nb"]
        expected = dict(A=3 * nb * eval_batches, B1=3 * nb * steps, B2=3 * nb * steps, C=steps, D=0, E=0, F=0)
        print(f"# trainer launches: {steps} steps x (3 x nb={nb} B1 + 3 x nb B2 + 1 C), {eval_batches} eval batches "
              f"({TRAINER_EPOCHS} val + 3 test) x 3 x nb A = {expected}; counted {launches}")
        if launches != expected or len(train) != steps or len(val) != TRAINER_EPOCHS:
            raise AssertionError(f"trainer: expected launches {expected} over {steps} logged steps and "
                                 f"{TRAINER_EPOCHS} validations, counted {launches}, {len(train)}, {len(val)}")
        if (gen["nf"], nb, gen["gc"], bs, cfg["trainer"]["precision"]) != (NF, NB, GC, TRAIN_N, "bf16"):
            raise AssertionError(f"trainer: the composed config is not the flagship at batch {TRAIN_N}: {gen}")

        with plain_rdb(), plain_training():
            *_, plain_train, plain_val, _, plain_wall = fit("plain")
        pairs = [(a["train/loss"], b["train/loss"]) for a, b in zip(train, plain_train)]
        pairs += [(a["val/rmse"], b["val/rmse"]) for a, b in zip(val, plain_val)]
        traj_err = max(abs(a - b) / abs(b) for a, b in pairs)
        print(f"# trainer kernels vs plain: train/loss and val/rmse within {traj_err:.2e} (relative; tol "
              f"{TRAJECTORY_TOL:g})")
        if not traj_err <= TRAJECTORY_TOL or not all(np.isfinite(a) for a, _ in pairs):
            raise AssertionError("trainer through the kernels disagrees with the plain versions")

        # the best checkpoint into a fresh generator: its validation reproduces
        # the logged val/rmse; the latest gives the trained model's output
        mgr = CheckpointManager(run_dir / "checkpoints", save_top_k=-1)
        kw = dict(dtype=torch.bfloat16, device=device, train=True, in_channels=3, out_channels=1, nf=gen["nf"],
                  nb=nb, gc=gen["gc"])
        store = build_eval_device_store(dm.val_dataset, device=device)
        n_val = len(dm.val_dataset)
        batches = [gather(store, torch.arange(i, min(i + vbs, n_val), device=device)) for i in range(0, n_val, vbs)]
        fresh = create_generator("esrgan", **kw)
        fresh.load_state_dict(load_generator_checkpoint(mgr.path(mgr.best_step)), strict=True)
        eval_step = make_eval_step(fresh, "esrgan", device=device)
        # the Trainer's epoch mean: batch means weighted by batch size
        best_rmse = sum(eval_step(b)["val/rmse"].item() * len(b["hr"]) for b in batches) / n_val
        batch = batches[0]
        logged = next(r["val/rmse"] for r in val if r["step"] == mgr.best_step)
        latest = create_generator("esrgan", **kw)
        latest.load_state_dict(load_generator_checkpoint(mgr.path(mgr.latest_step)), strict=True)
        tiles = {k: v[:16] for k, v in batch.items()}
        with torch.inference_mode():
            out = [apply_generator_batch("esrgan", m, tiles, torch.bfloat16) for m in (latest, trained[0])]
        ckpt_err = (out[0] - out[1]).abs().max().item()
        print(f"# trainer checkpoints: best step {mgr.best_step} re-validated val/rmse {best_rmse:.6f} against "
              f"logged {logged:.6f}; latest step {mgr.latest_step} on 16 tiles: max |loaded - trained| {ckpt_err:.3e}")
        if abs(best_rmse - logged) > 1e-5 * abs(logged) or ckpt_err != 0.0:
            raise AssertionError("trainer: a checkpoint read back does not give the trained model's numbers")

        # kernel A in the trained generator on this path's eval inputs (a
        # validation batch of 192, and of 64 as a test set's), against the
        # plain RDB on the same inputs
        for n in sorted(set(eval_sizes)):
            tiles = {k: v[:n] for k, v in batch.items()}
            with torch.inference_mode():
                got = apply_generator_batch("esrgan", trained[0], tiles, torch.bfloat16)
                with plain_rdb():
                    ref = apply_generator_batch("esrgan", trained[0], tiles, torch.bfloat16)
            rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            print(f"# trainer's generator on {n} val tiles, kernel A against the plain RDB: relative err {rel:.3e} "
                  f"(tol {GENERATOR_TOL[torch.bfloat16]:g})")
            if not rel <= GENERATOR_TOL[torch.bfloat16] or not torch.isfinite(got).all():
                raise AssertionError(f"trainer: the trained generator through kernel A disagrees with the plain RDB")

        # the streaming path (no device store): the val loader through pinned
        # memory and a side stream gives the store's batches bit for bit
        loader = DataLoader(dm.val_dataset, vbs, shuffle=False, drop_last=False, pad_last=True, num_workers=8)
        n = 0
        for got, want in zip(device_prefetch(iter(loader), device), batches):
            nv = len(want["hr"])
            if got["hr"].device != want["hr"].device or not all(torch.equal(got[k][:nv], v) for k, v in want.items()):
                raise AssertionError("device_prefetch: a batch differs from the device store's")
            n += 1
        print(f"# device_prefetch: {n} val batch(es) through pinned host memory and a side stream equal the "
              f"device store's, bit for bit")

    sps = train[-1]["train/samples_per_sec"]
    print(f"# trainer samples/s: {sps:.2f} (train/samples_per_sec at step {steps}, epoch {TRAINER_EPOCHS}) against "
          f"{TRAIN_N / step_ms * 1e3:.2f} for phase 7's bare step at batch {TRAIN_N}; fit + test {wall:.3f} s "
          f"({plain_wall:.3f} s plain); synthetic set {data_s:.3f} s ({card})")
    return dict(launches=launches, samples_per_sec=sps, eval_sizes=eval_sizes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from climsr_tpu_torch.ops import cuda_lib, head, head_bwd, rdb
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
                           "climsr_head_bwd": head_bwd._SOURCES, "climsr_hr_tail": head._SOURCES})
    print(f"# built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.3f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"#   ptxas {name}: {line.strip()}")

    # 3. kernel A against its plain version, at the flagship and the reference-default growth widths
    kernel_a = phase_kernel(device, shapes=((16, 128, 128), (2, 45, 91), *EVAL_SHAPES),
                            timed=((16, 128, 128), *EVAL_SHAPES))
    kernel_ref = phase_kernel(device, gc=GC_REF)[(16, 128, 128), False]
    phase_kernel(device, gc=48, shapes=((2, 45, 91),))

    # 4. the generator at the flagship widths and at the reference defaults
    phase_generator(device)
    phase_generator(device, nb=NB_REF, gc=GC_REF)

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
    train_kernels_ref = phase_train_kernels(device, gc=GC_REF)
    phase_train_kernels(device, gc=48, shapes=((3, 29, 45),))
    train_kernels["conv9_dx_c0"] = phase_head_kernel(device)

    # 7. pre-training and an eval step at full width
    pretrain = phase_pretrain(device)
    print(f"# pre-training step, batch {TRAIN_N}: {pretrain['ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['ms'] * 1e3:.2f} samples/s) through the kernels, {pretrain['plain_ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['plain_ms'] * 1e3:.2f} samples/s) through the plain versions ({card})")

    # 8. kernels D, E, F against their plain versions; D's and E's own paths
    rdb_nhwc = phase_rdb_nhwc(device)
    rdb_nhwc_ref = phase_rdb_nhwc(device, gc=GC_REF)
    hr_tail = phase_hr_tail(device)
    phase_dc0(device)
    own = path_rdb_nhwc_and_hr_tail(device)

    # 9. the probe: F's own path
    probe = phase_probe(device)

    # 10. the GAN fine-tune and a val-loss call at full width
    gan = phase_gan(device)
    print(f"# GAN step, batch {TRAIN_N}: {gan['ms']:.3f} ms/step ({TRAIN_N / gan['ms'] * 1e3:.2f} samples/s) "
          f"through the kernels, {gan['plain_ms']:.3f} ms/step ({TRAIN_N / gan['plain_ms'] * 1e3:.2f} samples/s) "
          f"through the plain versions ({card})")

    # 11. pre-training at the reference defaults (nf=64, nb=23, gc=32)
    pre_ref = phase_pretrain(device, nb=NB_REF, gc=GC_REF, steps=REF_STEPS)
    print(f"# pre-training step nf={NF} nb={NB_REF} gc={GC_REF}, batch {TRAIN_N}: {pre_ref['ms']:.3f} ms/step "
          f"({TRAIN_N / pre_ref['ms'] * 1e3:.2f} samples/s) through the kernels, {pre_ref['plain_ms']:.3f} ms/step "
          f"({TRAIN_N / pre_ref['plain_ms'] * 1e3:.2f} samples/s) through the plain versions ({card})")
    # 12. the kernels at gc=32, beside gc=16's in the JSON line below
    for name, r in (("fused_rdb", kernel_ref), ("fused_rdb_fwd_save", train_kernels_ref["fused_rdb_fwd_save"]),
                    ("fused_rdb_bwd", train_kernels_ref["fused_rdb_bwd"]), ("fused_rdb_nhwc", rdb_nhwc_ref)):
        print(f"# {name} at gc={GC_REF}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e} ({card})")

    # 13. the training entry point: composed config, data path, Trainer, checkpoints
    trainer = phase_trainer(device, pretrain["ms"], card)

    # 14. results
    # A, B1, B2 and C: their launches on this slice's main path, the training
    # entry point (phase 13); D, E, F run on no model path. A's numbers are per
    # launch over phase 13's: each eval batch of n tiles runs A on n x 64 x 32 x 32
    # twice without x0 and once with it in each of nb blocks
    kernel = launch_mean([kernel_a[(n, TRAIN_LR, TRAIN_LR), x0] for n in trainer["eval_sizes"]
                          for x0 in (False, False, True)])
    print(f"# fused_rdb per launch over phase 13's eval batches {trainer['eval_sizes']}: {kernel['ms']:.4f} ms, "
          f"plain {kernel['plain_ms']:.4f} ms, bound {kernel['bound_ms']:.4f} ms ({kernel['bound_by']}), "
          f"max_abs_err {kernel['max_abs_err']:.3e} ({card})")
    kernels = [dict(name="fused_rdb", route="cuda", source="climsr_tpu_torch/csrc/rdb_fwd.cu",
                    replaces="climsr_tpu/ops/pallas/rdb.py:190", launches=trainer["launches"]["A"], library_ms=None,
                    **kernel)]
    for name, label, source, replaces in (
        ("fused_rdb_fwd_save", "B1", "climsr_tpu_torch/csrc/rdb_fwd.cu", "climsr_tpu/ops/pallas/rdb.py:315"),
        ("fused_rdb_bwd", "B2", "climsr_tpu_torch/csrc/rdb_bwd.cu", "climsr_tpu/ops/pallas/rdb.py:432"),
        ("conv9_dx_c0", "C", "climsr_tpu_torch/csrc/conv9_dx_c0.cu", "climsr_tpu/ops/pallas/head_bwd.py:53"),
    ):
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=trainer["launches"][label], **train_kernels[name]))
    # D, E, F: their launches are their own paths' (phases 8, 9)
    kernels.append(dict(name="fused_rdb_nhwc", route="cuda", source="climsr_tpu_torch/csrc/rdb_fwd.cu",
                        replaces="climsr_tpu/ops/pallas/rdb.py:83", launches=own["fused_rdb_nhwc"], **rdb_nhwc))
    kernels.append(dict(name="fused_hr_tail", route="cuda", source="climsr_tpu_torch/csrc/hr_tail.cu",
                        replaces="climsr_tpu/ops/pallas/head.py:58", launches=own["fused_hr_tail"], **hr_tail))
    for name, line in (("dc0_flat", 48), ("dc0_dyfac", 68)):  # F1, F2: kernel C's source through F's entry
        kernels.append(dict(name=name, route="cuda", source="climsr_tpu_torch/csrc/conv9_dx_c0.cu",
                            replaces=f"scripts/bench_head_bwd_probe.py:{line}", **probe[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
