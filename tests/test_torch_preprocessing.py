# -*- coding: utf-8 -*-
"""The port's 7-step preprocessing against the JAX package's on the same raw
inputs: the JAX test's fabricated world (``tests/test_preprocessing.py``,
target grid shrunk to 288 x 144 in both packages' ``consts.world_clim``).

- the same output files, relative to each output root;
- every GeoTIFF array bitwise equal (resize, tavg, tiles, extents, CRU-TS);
- every feather equal row for row: strings and ints equal, floats within
  1e-12 relative (the statistics are numpy reductions where the JAX package
  uses pandas', in the same order);
- one run through the CLI's ``spawn`` pool (``n_workers=2``) equal too;
- ``_tile_windows`` and the filename parsers equal the JAX ones;
- the download code with the network monkeypatched (as
  ``tests/test_data_download.py``): the URL tables, 404s, retries, archives,
  cleanup and the peaks table; ``cli.data_preparation`` dispatches as the
  repository's root ``data_preparation.py`` does for the same arguments.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import climsr_tpu.consts as jax_consts
from climsr_tpu.preprocessing import preprocessing as JP
from climsr_tpu_torch import consts
from climsr_tpu_torch.cli import preprocess
from climsr_tpu_torch.config.schemas import PreProcessingConfig
from climsr_tpu_torch.data.tables import read_feather
from climsr_tpu_torch.io.geotiff import read_geotiff
from climsr_tpu_torch.preprocessing import preprocessing as P
from test_preprocessing import raw_world  # noqa: F401  (the JAX test's fixture)

torch.set_num_threads(1)

STEPS = preprocess.STEPS
FLOAT_RTOL = 1e-12


@pytest.fixture()
def world(raw_world, monkeypatch):  # noqa: F811
    monkeypatch.setattr(consts.world_clim, "target_hr_resolution", (288, 144))
    cfg, out = raw_world
    for step in STEPS:
        getattr(JP, step)(cfg)
    return cfg, Path(out)


def _port_run(cfg, out: Path, **kw) -> Path:
    port_cfg = PreProcessingConfig(**{**dataclasses.asdict(cfg), "output_path": str(out), **kw})
    seconds = preprocess.run(port_cfg)
    assert list(seconds) == list(STEPS)
    return out


def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_same_outputs(want_root: Path, got_root: Path) -> None:
    files = _files(want_root)
    assert files == _files(got_root)
    tiffs = [f for f in files if f.suffix == ".tif"]
    feathers = [f for f in files if f.suffix == ".feather"]
    assert len(tiffs) > 100 and len(feathers) >= 20
    for rel in tiffs:
        want, want_profile = read_geotiff(want_root / rel)
        got, got_profile = read_geotiff(got_root / rel)
        assert want.dtype == got.dtype and want.tobytes() == got.tobytes(), rel
        assert dataclasses.astuple(want_profile)[:6] == dataclasses.astuple(got_profile)[:6], rel
    for rel in feathers:
        want, got = read_feather(want_root / rel), read_feather(got_root / rel)
        assert got.columns == want.columns and len(got) == len(want) > 0, rel
        for c in want.columns:
            w, g = want[c], got[c]
            if w.dtype == object:
                w = [v if v is None else str(v).replace(str(want_root), str(got_root)) for v in w]
                assert list(g) == w, f"{rel}:{c}"
            elif w.dtype.kind == "f":
                assert g.dtype == w.dtype, f"{rel}:{c}"
                np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0, err_msg=f"{rel}:{c}")
            else:
                assert g.dtype == w.dtype, f"{rel}:{c}"
                np.testing.assert_array_equal(g, w, err_msg=f"{rel}:{c}")


def test_seven_steps_match_the_jax_package(world, tmp_path):
    cfg, jax_out = world
    port_out = _port_run(cfg, tmp_path / "port")
    _assert_same_outputs(jax_out, port_out)
    resized = read_geotiff(next((port_out / "pre-processed/world-clim/resized").rglob("*tmin*.tif")))[0]
    assert resized.shape == (144, 288) and np.isnan(resized[:15]).all()


def test_spawn_pool_matches_the_serial_run(world, tmp_path):
    cfg, jax_out = world
    pooled = _port_run(cfg, tmp_path / "pooled", n_workers=2)
    _assert_same_outputs(jax_out, pooled)


def test_tile_windows_and_parsers_match_the_jax_package():
    for args in ((100, 100, 64, 64, 32), (2880, 1440, 128, 128, 64), (288, 144, 64, 64, 32), (50, 70, 16, 8, 0)):
        assert list(P._tile_windows(*args)) == list(JP._tile_windows(*args))
    for name in ("wc2.1_2.5m_tmin_1999-02.tif", "wc2.1_10m_tmax_2010-12.tif", "wc2.1_2.5m_elev.tif",
                 "wc2.1_5m_tmin_BCC-CSM2-MR_ssp126_2021-2040.tif", "cruts-tmn-1999-01-16.tif"):
        for fn in ("_year_from_filename", "_month_from_filename", "_resolution_from_filename"):
            assert getattr(P, fn)(name) == getattr(JP, fn)(name), (fn, name)
    assert P._is_future(2020) and not P._is_future(2019)
    assert consts.world_clim.missing_indicators == jax_consts.world_clim.missing_indicators


# ---- data download (network monkeypatched) and data preparation -------------

def test_download_url_tables_match_the_jax_package():
    from climsr_tpu.preprocessing import data_download as jax_dd
    from climsr_tpu_torch.preprocessing import data_download as dd

    for name in ("get_cruts_data_download_urls", "get_world_clim_historical_climate_data_download_urls",
                 "get_world_clim_historical_weather_data_download_urls",
                 "get_world_clim_future_climate_data_download_urls"):
        urls = getattr(dd, name)()
        assert urls and urls == getattr(jax_dd, name)(), name
    assert len(dd.get_cruts_data_download_urls()) == 3


def test_download_tolerates_404_skips_existing_and_retries(tmp_path, monkeypatch):
    import gzip
    import sys
    import zipfile

    from climsr_tpu_torch.preprocessing import data_download as dd

    class FakeRequests:
        @staticmethod
        def get(url, stream=True):
            return SimpleNamespace(status_code=404, reason="Not Found")

    monkeypatch.setitem(sys.modules, "requests", FakeRequests)
    assert dd.download_file("http://x/y.zip", str(tmp_path)) == (None, "Not Found")
    (tmp_path / "a.gz").write_bytes(b"x")
    assert dd.download_file("http://x/a.gz", str(tmp_path)) == (str(tmp_path / "a.gz"), None)

    good = gzip.compress(b"climate")
    calls = []

    def fake_download(url, download_dir):  # a corrupt archive first, a good one on the retry
        calls.append(url)
        out = Path(download_dir) / "archives" / url.split("/")[-1]
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"garbage-not-gzip" if len(calls) == 1 else good)
        return str(out), None

    monkeypatch.setattr(dd, "download_file", fake_download)
    dd.try_file_download_and_extraction("http://x/data.txt.gz", str(tmp_path / "dl"))
    assert len(calls) == 2 and (tmp_path / "dl" / "extracted" / "data.txt").read_bytes() == b"climate"

    (tmp_path / "archives").mkdir()
    with zipfile.ZipFile(tmp_path / "archives" / "bundle.zip", "w") as zf:
        zf.writestr("inner/file.tif", b"tifdata")
    dd.handle_file_extraction(str(tmp_path / "archives" / "bundle.zip"))
    assert (tmp_path / "extracted" / "bundle" / "inner" / "file.tif").read_bytes() == b"tifdata"


def test_cleanup_and_the_peaks_fallback_table(tmp_path):
    import pandas as pd

    from climsr_tpu.preprocessing.scrape_polish_mountains import build_fallback_table as jax_fallback
    from climsr_tpu_torch.data.tables import write_feather
    from climsr_tpu_torch.preprocessing.cleanup import cleanup
    from climsr_tpu_torch.preprocessing.scrape_polish_mountains import build_fallback_table

    (tmp_path / "sub").mkdir()
    (tmp_path / "keep.nc").write_text("k")
    for i in range(5):
        (tmp_path / "sub" / f"t{i}.tif").write_text("x")
    assert cleanup(str(tmp_path), pattern="**/*.tif", n_workers=2) == 5
    assert (tmp_path / "keep.nc").exists() and not list((tmp_path / "sub").glob("*.tif"))
    write_feather(build_fallback_table(), tmp_path / "peaks.feather")
    pd.testing.assert_frame_equal(pd.read_feather(tmp_path / "peaks.feather"), jax_fallback(), check_dtype=False)


@pytest.mark.parametrize("argv", [
    [],
    ["run_download=false"],
    ["run_download=no", "run_preprocessing=yes", "preprocessing.n_workers=2"],
    ["run_preprocessing=false", "run_download=true", "data_download.download_path=/x"],
    ["run_download=off", "run_preprocessing=off"],
])
def test_data_preparation_flags_match_the_root_script(argv, monkeypatch):
    import importlib.util
    import sys

    import climsr_tpu.cli.data_download as jax_download
    import climsr_tpu.cli.preprocess as jax_preprocess
    import climsr_tpu_torch.cli.data_download as download
    from climsr_tpu_torch.cli import data_preparation

    spec = importlib.util.spec_from_file_location("root_data_preparation",
                                                  Path(__file__).resolve().parents[1] / "data_preparation.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    calls = {"jax": [], "port": []}
    for side, modules in (("jax", (jax_download, jax_preprocess)), ("port", (download, preprocess))):
        for name, module in zip(("download", "preprocess"), modules):
            monkeypatch.setattr(module, "main", lambda a, _n=name, _s=side: calls[_s].append((_n, list(a))))
    monkeypatch.setattr(sys, "argv", ["data_preparation.py", *argv])
    root.main()
    data_preparation.main(argv)
    assert calls["port"] == calls["jax"]
