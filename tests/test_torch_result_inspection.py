# -*- coding: utf-8 -*-
"""Result inspection and the ``log_images`` callback against the JAX package.

- ``CompareStatsResults.compute`` on the same ``ClimateSeries`` (NaN months
  and ocean included): every statistic within 1e-12 relative;
- ``cli.inspect_results`` against the JAX CLI on the same NetCDF pair and
  peaks feather (written by the port, read by pandas in the JAX CLI): the
  three CSVs hold the same columns and, parsed, the same values; the plots
  are written (matplotlib is installed here);
- ``make_grid`` bitwise equal to the JAX one (matplotlib's colour tables)
  for jet, inferno and gray, with masks, NaN and inf;
- ``LogImagesCallback`` on the same validation samples and generator output
  as the JAX callback: the same six tags and grids, bit for bit; through
  ``cli.train`` with ``callbacks=[log_images]`` its six tags are logged.
"""
import csv
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsr_tpu.cli import inspect_results as jax_cli
from climsr_tpu.result_inspection.models import CompareStatsResults as JaxCompare
from climsr_tpu.training import callbacks as jax_callbacks
from climsr_tpu_torch.cli import inspect_results
from climsr_tpu_torch.data.tables import write_feather
from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series
from climsr_tpu_torch.preprocessing.scrape_polish_mountains import build_fallback_table
from climsr_tpu_torch.result_inspection.models import CompareStatsResults
from climsr_tpu_torch.training import callbacks

torch.set_num_threads(1)

RTOL = 1e-12
TAGS = ["val/hr_images", "val/elevation", "val/nearest_interpolation", "val/cubic_interpolation",
        "val/sr_images", "val/error"]


def _series(rng, var, months=6, shift=0.0):
    lat = np.linspace(45.25, 55.75, 22)
    lon = np.linspace(10.25, 20.75, 22)
    data = (rng.normal(5, 8, size=(months, 22, 22)) + shift).astype(np.float32)
    data[:, :3] = np.nan  # "ocean" rows
    data[1, 10, 11] = np.nan  # a missing month at one probe
    time = np.array([f"2000-{m:02d}-16" for m in range(1, months + 1)], dtype="datetime64[D]")
    return ClimateSeries(var, data, time, lat, lon)


def _fields(results):
    out = [results.mae, results.mse, results.rmse]
    for r in results.nn_results + results.cru_results:
        out += [r.lat, r.lon, r.mean, r.median, r.min, r.max, *r.quantiles.values()]
    return np.asarray(out, np.float64)


def test_compare_stats_results_match_the_jax_package(rng):
    nn, cru = _series(rng, "tmp"), _series(rng, "tmp", months=8, shift=0.5)
    lats, lons = [50.1, 51.0, 46.0, 55.5], [15.5, 16.7, 12.0, 19.9]
    args = (lats, lons, [402, None, 646, 709], ["a", "b", "c", "d"])
    got, want = CompareStatsResults.compute(nn, cru, *args), JaxCompare.compute(nn, cru, *args)
    np.testing.assert_allclose(_fields(got), _fields(want), rtol=RTOL, atol=0)
    frame = got.to_frame()
    assert frame.columns == list(want.to_frame().columns) and len(frame) == 4
    assert [r.alt for r in got.nn_results] == [402, None, 646, 709]


def _parsed(cell: str):
    try:
        return float(cell)
    except ValueError:
        return cell


def _cells(path: Path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [[_parsed(c) for c in row] for row in rows[1:]]


def test_inspect_results_cli_matches_the_jax_cli(rng, tmp_path):
    var = "tmp"
    nn_path = tmp_path / f"esrgan.cru_ts4.05.nn.inference.1901.2020.{var}.dat.nc"
    cru_path = tmp_path / f"cru_ts4.05.1901.2020.{var}.dat.nc"
    write_climate_series(nn_path, _series(rng, var))
    write_climate_series(cru_path, _series(rng, var, months=8, shift=0.5))
    peaks = tmp_path / "peaks.feather"
    write_feather(build_fallback_table(), peaks)
    common = [f"result_inspection.ds_temp_nn_path={nn_path}", f"result_inspection.ds_temp_cru_path={cru_path}",
              f"result_inspection.peaks_feather={peaks}"]
    jax_cli.main(common + [f"result_inspection.results_dir={tmp_path / 'jax'}"])
    out = inspect_results.main(common + [f"result_inspection.results_dir={tmp_path / 'port'}"])
    assert list(out) == ["peaks_feather", "mountain_peaks", "2_locations"]
    for tag in out:
        header, rows = _cells(tmp_path / "port" / f"{tag}.csv")
        want_header, want_rows = _cells(tmp_path / "jax" / f"{tag}.csv")
        assert header == want_header and len(rows) == len(want_rows) > 0, tag
        for row, want in zip(rows, want_rows):
            for a, b in zip(row, want):
                if isinstance(b, float) and isinstance(a, float):
                    assert a == pytest.approx(b, rel=RTOL, abs=0, nan_ok=True), tag
                else:
                    assert a == b, tag
        for kind in ("line", "box"):
            assert (tmp_path / "port" / f"{tag}_{kind}.png").stat().st_size > 0


@pytest.mark.parametrize("cmap", ["jet", "inferno", "gray"])
def test_make_grid_matches_the_jax_package_bitwise(cmap):
    rng = np.random.default_rng(7)
    imgs = rng.normal(size=(5, 16, 12)).astype(np.float32)
    imgs[1, 2:5, 3] = np.nan
    imgs[2, 0, 0] = np.inf
    imgs[3] = 4.0  # a constant image
    imgs[4] = np.nan  # nothing finite
    masks = (rng.random((5, 16, 12)) > 0.3).astype(np.float32)
    for m in (masks, None):
        for nrow in (2, 8):
            got = callbacks.make_grid(imgs, m, nrow=nrow, cmap=cmap)
            want = jax_callbacks.make_grid(imgs, m, nrow=nrow, cmap=cmap)
            assert got.dtype == np.uint8 and np.array_equal(got, want)


class _Recorder:
    def __init__(self):
        self.images = []

    def log_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))


def _samples(rng, n=3, hr=16):
    """Validation samples as the datasets give them (HWC float32)."""
    def raster(c=1, size=hr):
        return rng.normal(size=(size, size, c)).astype(np.float32)

    out = []
    for _ in range(n):
        mask = (rng.random((hr, hr, 1)) > 0.25).astype(np.float32)
        out.append({"lr": raster(3, hr // 4), "hr": raster(), "elevation": raster(), "mask": mask,
                    "nearest": raster(), "cubic": raster()})
    return out


class _PortGenerator(torch.nn.Module):
    """The same deterministic "SR" as the JAX stand-in below: 2 * elevation - mask."""

    def __init__(self):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(()))

    def forward(self, lr, elevation, mask):
        return 2 * elevation - mask


def test_log_images_matches_the_jax_callback(rng):
    samples = _samples(rng)
    port_log, jax_log = _Recorder(), _Recorder()
    port_trainer = SimpleNamespace(val_loader=SimpleNamespace(dataset=samples), generator_type="esrgan",
                                   g_model=_PortGenerator(), compute_dtype=torch.float32, global_step=5,
                                   metric_logger=port_log)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    jax_trainer = SimpleNamespace(
        val_loader=[dict(batch)], generator_type="esrgan", compute_dtype=jnp.float32, global_step=5,
        metric_logger=jax_log, _generator_params=lambda: {},
        g_model=SimpleNamespace(apply=lambda params, lr, elevation, mask: 2 * elevation - mask))
    port_cb, jax_cb = callbacks.LogImagesCallback(max_images=8), jax_callbacks.LogImagesCallback(max_images=8)
    for epoch in range(2):
        port_cb.on_validation_end(port_trainer, epoch, {})
        jax_cb.on_validation_end(jax_trainer, epoch, {})
    assert [t for t, _, _ in port_log.images] == [t for t, _, _ in jax_log.images] == TAGS + TAGS[-2:]
    for (tag, got, step), (_, want, _) in zip(port_log.images, jax_log.images):
        assert step == 5 and got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), tag


def test_log_images_through_the_training_cli(tmp_path, monkeypatch):
    from climsr_tpu_torch.cli.train import main
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.utils.logging import MetricLogger

    make_synthetic_dataset(tmp_path / "ds", n_tiles_per_stage=(4, 2, 2))
    logged = []
    monkeypatch.setattr(MetricLogger, "log_image", lambda self, tag, image, step: logged.append((tag, image.shape)))
    main(["--device=cpu", "experiment=esrgan_pre_training", "generator.nf=8", "generator.nb=1", "generator.gc=8",
          "training.batch_size=4", "training.validation_batch_size=4", "training.num_workers=2",
          "trainer.max_epochs=1", "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
          "trainer.precision=fp32", "training.run_test_after_fit=false", "logger=csv", "print_config=false",
          f"datamodule.cfg.data_path={tmp_path / 'ds'}", f"training.output_dir={tmp_path / 'out'}",
          "callbacks=[log_images]"])
    assert [t for t, _ in logged] == TAGS
    assert all(shape[-1] == 3 and shape[0] % 128 == 0 for _, shape in logged)
