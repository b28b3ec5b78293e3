"""The whole-globe sweep: one CRU-TS decade file through the port's
``inference_on_full_images``, as ``run_inference`` drives it.

Set-up writes the seed's world (``data.make_globe``: the decade's NetCDF,
the land mask and the elevation) under the run's temporary directory, builds
the generator in bf16 with the seed's weights, and sweeps the first group of
months once to build and warm every shape. Each sweep of the window builds
its dataset as ``run_inference`` does, so the NetCDF read and each month's
normalization are inside it, and writes one GeoTIFF a month. The window runs
whole sweeps back to back until ``--seconds`` have passed.

A few months of each sweep, drawn from the seed, are written as files and
compared with the reference (``reference/sweep.py``, float32, TF32 off)
after the window; every other month's path is a symbolic link to
``/dev/null``, so the program encodes and writes it and nothing reaches the
disk. Compared: the widest gap on land over half the month's range, and the
pixels whose NaN (ocean) layout differs, which must be none.
"""
from __future__ import annotations

import gc
import importlib
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import data
from perfbench.harness import Cell, Outcome
from perfbench.reference import esrgan, sweep as ref_sweep
from perfbench.trace import WINDOW, Spans, device_pass, profiled, read_trace

NETCDF = "cru_ts4.05.1901.2020.tmp.dat.nc"


class _FirstMonths:
    """The dataset's first ``n`` months (the warm-up sweep)."""

    def __init__(self, ds, n: int):
        self._ds, self._n = ds, n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int):
        return self._ds[i]

    def __getattr__(self, name):
        return getattr(self._ds, name)


def month_names(times: np.ndarray) -> List[str]:
    """The output file of each month, as CRU-TS names them: ``cruts-<var>-<date>.tif``."""
    return [f"cruts-tmp-{np.datetime_as_string(t, unit='D')}.tif" for t in times]


def checked_months(seed: int, sweep: int, months: int, per_sweep: int) -> List[int]:
    rng = np.random.default_rng([int(seed), sweep])
    return sorted(int(m) for m in rng.choice(months, size=min(per_sweep, months), replace=False))


def route_outputs(out: Path, names: List[str], keep: List[int]) -> None:
    """Every month's path but those in ``keep`` a link to /dev/null."""
    out.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        if i not in keep:
            os.symlink(os.devnull, out / name)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float, control: bool) -> Outcome:
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.models import create_generator

    gen, tr = cell.config["generator"], cell.traffic
    s = gen["scaling_factor"]
    root = Path(tempfile.mkdtemp(prefix="perfbench-"))
    cuda = device.type == "cuda"
    try:
        marks = {"start": time.perf_counter() - start}
        world = data.make_globe(root, tr["months"], tr["lr_h"], tr["lr_w"], seed, s)
        marks["data"] = time.perf_counter() - start
        p0 = esrgan.seeded_params(gen, seed, device)
        static = ref_sweep.static_inputs(world["elevation"], world["mask"], s)
        if control:
            return _control(cell, seed, world, static, p0, device)
        names = month_names(world["time"])
        model = create_generator(gen["name"], dtype=torch.bfloat16, device=device, in_channels=gen["in_channels"],
                                 out_channels=gen["out_channels"], nf=gen["nf"], nb=gen["nb"], gc=gen["gc"],
                                 scaling_factor=s)
        model.load_state_dict(p0, strict=True)

        def dataset():
            return CRUTSInferenceDataset(
                ds_path=str(root / NETCDF), elevation_file=str(root / "elevation.tif"),
                land_mask_file=str(root / "land_mask.tif"), generator_type=gen["name"], scaling_factor=s,
                normalize=True, standardize=False, normalize_range=(-1.0, 1.0), use_elevation=True, use_mask=True)

        def sweep(ds, out: Path) -> List[str]:
            return inference_on_full_images(
                model, ds, str(out), gen["name"], normalization_range=(-1.0, 1.0), batch_size=tr["batch_size"],
                tile_size=tr["tile_size"], tile_overlap=tr["tile_overlap"], scaling_factor=s,
                readback=tr["readback"], device=device)

        warm = root / "warm"
        route_outputs(warm, names, [])
        marks["model"] = time.perf_counter() - start
        sweep(_FirstMonths(dataset(), tr["group"]), warm)

        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        setup_s = t0 - start
        done: List[Tuple[int, List[int], List[str]]] = []
        while True:
            i = len(done)
            keep = checked_months(seed, i, tr["months"], tr["checked_per_sweep"])
            out = root / f"sweep{i}"
            route_outputs(out, names, keep)
            done.append((i, keep, sweep(dataset(), out)))
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0

        summary = None
        if trace:
            from climsr_tpu_torch.inference import run as inference_run, tiled

            bare, traced = root / "traced-device", root / "traced"
            route_outputs(bare, names, [])
            route_outputs(traced, names, [])
            timeline = device_pass(device, lambda: sweep(dataset(), bare))
            spans = Spans()
            spans.rdb()
            spans.wrap(CRUTSInferenceDataset, "__getitem__", "perfbench.dataset_month")
            spans.wrap(tiled.TiledSR, "device_call_many", "perfbench.tiler_group")
            spans.wrap(inference_run, "write_geotiff", "perfbench.write_geotiff")
            spans.wrap(inference_run, "unpack12", "perfbench.unpack12")
            spans.wrap(inference_run, "_denormalize", "perfbench.denormalize")
            try:
                with profiled() as holder:
                    with torch.profiler.record_function(WINDOW):
                        with torch.profiler.record_function("perfbench.dataset_build"):
                            ds = dataset()
                        sweep(ds, traced)
                        if cuda:
                            torch.cuda.synchronize(device)
                summary = read_trace(holder[0], timeline)
                marks["trace"] = summary.counts
            finally:
                spans.close()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        expected = len(done) * tr["months"]
        written = sum(len(paths) for _, _, paths in done)
        refs: Dict[int, np.ndarray] = {}
        worst, nan_wrong, bad = 0.0, 0, 0
        for i, keep, _ in done:
            for m in keep:
                if m not in refs:
                    refs[m] = ref_sweep.downscale_month(p0, gen, world["data"][m], static, device,
                                                        tile=tr["tile_size"], overlap=tr["tile_overlap"])
                path = root / f"sweep{i}" / names[m]
                if path.is_file() and not path.is_symlink():
                    got = ref_sweep.read_tiff(str(path))
                    gap, wrong = ref_sweep.month_gap(got, refs[m], static["land"],
                                                     *ref_sweep.month_range(world["data"][m]))
                else:
                    gap, wrong = float("inf"), int(static["land"].size)
                worst, nan_wrong = max(worst, gap), nan_wrong + wrong
                bad += int(not (gap <= cell.limits["sweep_gap"] and wrong == 0))
        marks["reference_s"] = time.perf_counter() - t_ref
        family = importlib.import_module(f"perfbench.counts.{cell.config['family']}")
        months = len(done) * tr["months"]
        return Outcome(
            kind="sweep",
            end_to_end={"sweep_months_per_s": months / wall, "setup_s": setup_s},
            attempted=expected, failed=expected - written + bad, memory_peak_bytes=int(peak),
            checks={"sweep_gap": worst, "nan_mismatch": float(nan_wrong)}, window_s=wall,
            flops=months * family.forward_flops(gen, 1, tr["lr_h"], tr["lr_w"]), trace=summary,
            notes={"sweeps": len(done), "checked": [(i, keep) for i, keep, _ in done], "setup_marks_s": marks},
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _control(cell: Cell, seed: int, world, static, p0, device) -> Outcome:
    """The reference in float8 put in the program's place, on as many months
    as three sweeps check, held to the same numbers."""
    gen, tr = cell.config["generator"], cell.traffic
    months = sorted({m for i in range(3) for m in checked_months(seed, i, tr["months"], tr["checked_per_sweep"])})
    tiles = dict(tile=tr["tile_size"], overlap=tr["tile_overlap"])
    worst, wrong = 0.0, 0
    for m in months:
        ref = ref_sweep.downscale_month(p0, gen, world["data"][m], static, device, **tiles)
        low = ref_sweep.downscale_month(p0, gen, world["data"][m], static, device, **tiles, conv=esrgan.fp8_conv)
        gap, nan_wrong = ref_sweep.month_gap(low, ref, static["land"], *ref_sweep.month_range(world["data"][m]))
        worst, wrong = max(worst, gap), wrong + nan_wrong
    return Outcome(kind="sweep", end_to_end={}, attempted=len(months), failed=0, memory_peak_bytes=0,
                   checks={"sweep_gap": worst, "nan_mismatch": float(wrong)})
