# -*- coding: utf-8 -*-
"""Spatial sharding and the multi-rank entry points on 4 gloo ranks of the CPU.

One group of 4 ranks runs per file (``parallel.launch.spawn`` of
``climsr_tpu_torch.parallel.cases:main`` on a (1, 4) ``("data", "spatial")``
mesh, fresh interpreters that import no JAX):

- the H-sharded ESRGAN forward (nf=8, nb=1, a 30-row LR frame padded to 32,
  halo 6) and its parameter gradient against the JAX
  ``spatial_sharded_model_forward`` on the virtual CPU mesh, forward at atol
  1e-5 / rtol 1e-5 and gradients at atol 1e-5 / rtol 1e-4
  (``tests/test_spatial_train.py:45``, ``:69``). The JAX side takes ~2 min to
  compile on the CPU, so tier-1 reads its recorded output
  (``fixtures/jax_spatial_record.npz``); the ``slow`` test runs it live and
  checks the record, and ``python tests/test_torch_spatial.py`` rewrites it;
- RCAN's channel attention with the exact pool against the unsharded pool
  (1e-5), with a padded height, and a local-pool control that differs by more
  than 100x that; a tiny RCAN through the sharded forward in the interior;
- ``inference_on_full_images(spatial_shard=True)`` over the 4 ranks against
  the single-process whole-frame run;
- the spatial GAN step (SRCNN over a (2, 2) mesh) against one process with
  the edge-fair SRCNN;
- ``cli.train`` inside the group at ZeRO stage 3 (against the single-process
  run of the same config), resumed from its checkpoint, and with
  ``plugins=spatial_shard``; the best ``.ckpt`` of each loads into one
  generator with ``strict=True``.
"""
import csv
import glob
from pathlib import Path

import numpy as np
import pytest
import torch

from climsr_tpu_torch.parallel.cases import TRAIN_OVERRIDES
from climsr_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
RANKS = 4
RECORD = Path(__file__).parent / "fixtures" / "jax_spatial_record.npz"
ESR_WIDTHS = (8, 1, 8)  # nf, nb, gc
ESR_HALO = 6


def jax_spatial_record() -> dict:
    """The JAX side: seeded inputs and ESRGAN weights (as the port's
    state_dict), the sharded forward over a (1, 4) mesh and the gradient of
    the mean absolute error to ``hr`` (as the port's state_dict keys)."""
    import jax
    import jax.numpy as jnp

    from climsr_tpu.models import create_generator
    from climsr_tpu.parallel.halo import spatial_sharded_model_forward
    from climsr_tpu.parallel.mesh import create_mesh
    from climsr_tpu_torch.interop.params import state_dict_from_flax

    rng = np.random.default_rng(11)
    nf, nb, gc = ESR_WIDTHS
    rec = {
        "esr_lr": rng.normal(size=(2, 30, 8, 3)).astype(np.float32),
        "esr_elevation": rng.normal(size=(2, 120, 32, 1)).astype(np.float32),
        "esr_mask": (rng.random((2, 120, 32, 1)) > 0.3).astype(np.float32),
        "esr_hr": rng.normal(size=(2, 120, 32, 1)).astype(np.float32),
    }
    model = create_generator("esrgan", nf=nf, nb=nb, gc=gc, out_channels=1, use_pallas=False, dtype=jnp.float32)
    x = [jnp.asarray(rec[k]) for k in ("esr_lr", "esr_elevation", "esr_mask")]
    params = model.init(jax.random.PRNGKey(0), *x)["params"]
    mesh = create_mesh(RANKS, ("data", "spatial"), last_axis_size=RANKS)
    fwd = spatial_sharded_model_forward(model, "esrgan", mesh, halo=ESR_HALO, scale=4)
    hr = jnp.asarray(rec["esr_hr"])
    loss, grads = jax.value_and_grad(lambda p: jnp.mean(jnp.abs(fwd(p, *x) - hr)))(params)
    rec["jax_sr"] = np.asarray(fwd(params, *x))
    rec["jax_loss"] = np.asarray(loss)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    rec.update({f"esr/{k}": v.numpy() for k, v in state_dict_from_flax("esrgan", np_tree).items()})
    g_tree = jax.tree_util.tree_map(np.asarray, grads)
    rec.update({f"jax_grad/{k}": v.numpy() for k, v in state_dict_from_flax("esrgan", g_tree).items()})
    return rec


def _port_inputs(root: Path) -> dict:
    """RCAN cases, a tiny world of NetCDF months and rasters, a training set."""
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.io import geotiff, netcdf
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.rcan import CALayer

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 16, 8)).astype(np.float32)
    x[:, :32] += 3.0  # strong row dependence: the shards' local means differ by ~1.5
    pad = x.copy()
    pad[:, 61:] = x[:, 59:56:-1]  # the forward's reflect padding of a 61-row frame
    out = {"ca_x": x, "ca_x_pad": pad,
           "rcan_lr": rng.normal(size=(1, 64, 8, 3)).astype(np.float32),
           "rcan_elevation": rng.normal(size=(1, 256, 32, 1)).astype(np.float32),
           "rcan_mask": np.ones((1, 256, 32, 1), np.float32)}
    ca = CALayer(8, 4)
    for conv in (ca.conv_du[0], ca.conv_du[2]):  # a gate that reads the pool
        torch.nn.init.normal_(conv.weight, 0, 0.5, generator=torch.Generator().manual_seed(2))
    out.update({f"ca/{k}": v.numpy() for k, v in ca.state_dict().items()})
    rcan = create_generator("rcan", device="cpu", train=True, n_resgroups=2, n_resblocks=2, n_feats=8, reduction=4,
                            out_channels=1, generator=torch.Generator().manual_seed(3))
    out.update({f"rcan/{k}": v.numpy() for k, v in rcan.state_dict().items()})

    h, w, months = 64, 16, 2
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, :4] = np.nan
    time = np.array([f"1901-{m:02d}-16" for m in range(1, months + 1)], dtype="datetime64[D]")
    netcdf.write_climate_series(root / "cru_ts4.05.1901.2020.tmp.dat.nc", netcdf.ClimateSeries(
        "tmp", data, time, np.linspace(-89, 89, h), np.linspace(-179, 179, w)))
    mask = np.where(rng.random((4 * h, 4 * w)) > 0.4, 1.0, np.nan).astype(np.float32)
    geotiff.write_geotiff(root / "mask.tif", mask, geotiff.GeoProfile.global_grid(4 * h, 4 * w))
    elev = rng.normal(500, 300, size=(4 * h, 4 * w)).astype(np.float32)
    geotiff.write_geotiff(root / "elev.tif", elev, geotiff.GeoProfile.global_grid(4 * h, 4 * w, nodata=None))
    out.update(world_nc=np.asarray("cru_ts4.05.1901.2020.tmp.dat.nc"), world_elevation_file=np.asarray("elev.tif"),
               world_land_mask_file=np.asarray("mask.tif"))
    make_synthetic_dataset(root / "ds", n_tiles_per_stage=(4, 2, 2))
    # the spatial GAN step: 2 global batches of 4 SRCNN inputs (HR-sized) and targets
    out["sgan_lr"] = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    out["sgan_hr"] = rng.normal(size=(2, 4, 32, 32, 1)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("spatial")
    inp = {k: v for k, v in np.load(RECORD).items() if not k.startswith("jax_")}
    inp.update(_port_inputs(workdir), esr_widths=np.asarray(ESR_WIDTHS), esr_halo=np.asarray(ESR_HALO))
    np.savez(workdir / "inputs.npz", **inp)
    suites = ["spatial", "spatial_gan", "inference", "trainer"]
    spawn("climsr_tpu_torch.parallel.cases:main", RANKS,
          {"workdir": str(workdir), "suites": suites, "axes": ["data", "spatial"], "last_axis_size": RANKS},
          env={"OMP_NUM_THREADS": "1"}, timeout=600)
    return workdir, inp, {s: [dict(np.load(workdir / f"{s}_rank{r}.npz")) for r in range(RANKS)] for s in suites}


def _cat(results, key):
    return np.concatenate([r[key] for r in results], axis=1)


def test_spatial_esrgan_forward_and_gradient_match_jax(ranks):
    """A 30-row frame over 4 ranks (padded to 32; the last rank returns 28 HR
    rows fewer): the output and the parameters' gradient, summed over the
    ranks, against the JAX sharded forward."""
    _, _, res = ranks
    record = np.load(RECORD)
    out = res["spatial"]
    assert [tuple(r["esr_rows"]) for r in out] == [(0, 32), (32, 64), (64, 96), (96, 120)]
    np.testing.assert_allclose(_cat(out, "esr_sr"), record["jax_sr"], atol=1e-5, rtol=1e-5)
    keys = [k for k in record.files if k.startswith("jax_grad/")]
    assert len(keys) == sum(1 for k in out[0] if k.startswith("esr_grad/"))
    for k in keys:
        for r in out:
            np.testing.assert_allclose(r["esr_grad/" + k[len("jax_grad/"):]], record[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)


@pytest.mark.slow
def test_jax_spatial_record_matches_the_live_jax_run():
    live = jax_spatial_record()
    record = np.load(RECORD)
    assert sorted(record.files) == sorted(live)
    for k, v in live.items():
        np.testing.assert_allclose(record[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def _plain_ca(inp):
    from climsr_tpu_torch.models.rcan import CALayer

    ca = CALayer(8, 4)
    ca.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("ca/")})
    return lambda a: ca(torch.from_numpy(a).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()


def test_spatial_gan_step_matches_the_edge_fair_single_process_step(ranks):
    """2 GAN steps on a (2, 2) mesh, SRCNN H-sharded with a halo of its
    receptive field and its ``sr`` gathered for D and VGG, against one process
    with the same SRCNN on the reflect-padded frame (the sharded path's
    boundary condition): every loss term at rtol 1e-5, G's and D's parameters
    and D's running statistics at atol 1e-6."""
    from climsr_tpu_torch.parallel.cases import flat_results, spatial_gan_run

    _, inp, res = ranks
    state, metrics = spatial_gan_run(inp, None)
    want = flat_results("sgan", metrics, [("g", state.g_model.model), ("d", state.d_model)])
    for out in res["spatial_gan"]:
        for k, v in want.items():
            if "/metric/" in k:
                np.testing.assert_allclose(out[k], v, rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(out[k], v, atol=1e-6, err_msg=k)


def test_rcan_channel_attention_pools_the_whole_frame(ranks):
    """The halo-masked local sums summed over the ranks give the unsharded
    pool (1e-5); with 3 reflect-padded phantom rows on the last shard, the pool
    spans the 61 true rows; pooling each shard alone differs by more than 100x."""
    _, inp, res = ranks
    plain = _plain_ca(inp)
    want = plain(inp["ca_x"])
    exact = _cat(res["spatial"], "ca_exact")
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat(res["spatial"], "ca_pad")[:, :61], plain(inp["ca_x"][:, :61]),
                               atol=1e-5, rtol=1e-5)
    local = _cat(res["spatial"], "ca_local")
    assert np.abs(local - want).max() > 100 * max(np.abs(exact - want).max(), 1e-7)


def test_rcan_sharded_forward_matches_unsharded_in_the_interior(ranks):
    """Halo 15 covers the tiny RCAN's receptive field (~14 LR rows): rows more
    than 15 LR rows from the frame edges match the unsharded model (the edge
    ranks reflect where the model zero-pads); gradients flow through the
    all-reduced pools."""
    from climsr_tpu_torch.models import create_generator

    _, inp, res = ranks
    rcan = create_generator("rcan", device="cpu", train=True, n_resgroups=2, n_resblocks=2, n_feats=8, reduction=4,
                            out_channels=1)
    rcan.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("rcan/")})
    t = [torch.from_numpy(inp[k]).permute(0, 3, 1, 2) for k in ("rcan_lr", "rcan_elevation", "rcan_mask")]
    with torch.no_grad():
        want = rcan(*t).permute(0, 2, 3, 1).numpy()
    got = _cat(res["spatial"], "rcan_sr")
    assert got.shape == want.shape == (1, 256, 32, 1)
    np.testing.assert_allclose(got[:, 60:-60], want[:, 60:-60], atol=1e-5)
    assert all(bool(r["rcan_grad_finite"]) for r in res["spatial"])


def test_spatial_shard_inference_matches_the_whole_frame_run(ranks):
    """64 LR rows over 4 ranks (halo capped at 15): rank 0 writes the same
    months as the single-process whole-frame run, NaN on the sea, finite on
    land. Away from the frame's top and bottom 3 LR rows, seams included, the
    values agree within 1e-3 of the frame's half range (measured: 2e-4); the
    edge rows, reflected by the sharded run where the whole frame zero-pads,
    within 0.25 (measured: 8e-2)."""
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.models import create_generator

    workdir, inp, res = ranks
    assert [int(r["written"]) for r in res["inference"]] == [2, 0, 0, 0]
    model = create_generator("esrgan", device="cpu", dtype=torch.float32, nf=8, nb=1, gc=8, out_channels=1)
    model.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("esr/")})
    ds = CRUTSInferenceDataset(ds_path=str(workdir / "cru_ts4.05.1901.2020.tmp.dat.nc"), elevation_file=str(workdir / "elev.tif"),
                               land_mask_file=str(workdir / "mask.tif"), generator_type="esrgan", scaling_factor=4)
    want = inference_on_full_images(model, ds, str(workdir / "single"), "esrgan", batch_size=2, device="cpu")
    got = sorted(glob.glob(str(workdir / "spatial" / "*.tif")))
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = read_geotiff(a)[0], read_geotiff(b)[0]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(a[~np.isnan(b)]).all()
        half = (float(ds[i]["max"]) - float(ds[i]["min"])) / 2
        # the seams: within 1e-3 of the half range away from the frame's top and
        # bottom 12 HR rows; those reflect where the whole frame zero-pads
        np.testing.assert_allclose(a[12:-12], b[12:-12], rtol=0, atol=1e-3 * half)
        np.testing.assert_allclose(a, b, rtol=0, atol=0.25 * half)


def _rows(path):
    out, header = [], None
    with open(path) as f:
        for cells in csv.reader(f):
            if cells[0] == "step":
                header = cells
            else:
                out.append({k: float(v) for k, v in zip(header, cells)})
    return out


def _run_dir(out):
    (run,) = glob.glob(f"{out}/outputs/runs/esrgan/*")
    return run


def _best_loads(run):
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import create_generator

    (ckpt,) = glob.glob(f"{run}/checkpoints/*.ckpt")
    model = create_generator("esrgan", device="cpu", nf=32, nb=1, gc=16, out_channels=1)
    model.load_state_dict(load_generator_checkpoint(ckpt), strict=True)
    return torch.load(ckpt, map_location="cpu", weights_only=False)


def test_cli_train_zero3_over_ranks_matches_one_process(ranks, tmp_path):
    """ZeRO stage 3 over 4 ranks through ``cli.train`` (device store and
    augmentation drawn for the global batch; the parameters gathered for
    each validation and checkpoint; each eval batch split over the ranks):
    one run directory, the train losses and the validation metrics of the
    single-process run to 1e-5, and a checkpoint of the single-process layout
    (full-shape optimizer state) that loads with ``strict=True``."""
    from climsr_tpu_torch.cli.train import main

    workdir, _, _ = ranks
    main(["--device=cpu", *TRAIN_OVERRIDES, f"datamodule.cfg.data_path={workdir}/ds",
          f"training.output_dir={tmp_path}"])
    single = [r["train/loss"] for r in _rows(f"{_run_dir(tmp_path)}/metrics.csv") if "train/loss" in r]
    run = _run_dir(workdir / "zero")
    losses = [r["train/loss"] for r in _rows(f"{run}/metrics.csv") if "train/loss" in r]
    assert len(losses) == len(single) == 6  # 2 epochs of 3 steps
    np.testing.assert_allclose(losses, single, rtol=1e-5)
    val = [r for r in _rows(f"{run}/metrics.csv") if "val/rmse" in r]
    single_val = [r for r in _rows(f"{_run_dir(tmp_path)}/metrics.csv") if "val/rmse" in r]
    assert len(val) == len(single_val) == 2
    for got, want in zip(val, single_val):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    ckpt = _best_loads(run)
    sd = ckpt["state_dict"]
    for i, state in ckpt["optimizer_states"][0]["state"].items():
        assert state["exp_avg"].shape == state["exp_avg_sq"].shape
    shapes = {tuple(s["exp_avg"].shape) for s in ckpt["optimizer_states"][0]["state"].values()}
    assert tuple(sd["generator.trunk_conv.weight"].shape) in shapes


def test_cli_train_resumes_a_zero3_run_over_ranks(ranks):
    """The ZeRO-3 run's checkpoint resumed over the 4 ranks at stage 3 (its
    full optimizer state cut back into shards): the steps go on from 6, the
    losses are finite, and its checkpoint loads with ``strict=True``."""
    workdir, _, _ = ranks
    run = _run_dir(workdir / "resumed")
    rows = [r for r in _rows(f"{run}/metrics.csv") if "train/loss" in r]
    assert rows and rows[0]["step"] == 7 and np.isfinite([r["train/loss"] for r in rows]).all()
    _best_loads(run)


def test_cli_train_spatial_shard_plugin_over_ranks(ranks):
    workdir, _, _ = ranks
    run = _run_dir(workdir / "spatial")
    losses = [r["train/loss"] for r in _rows(f"{run}/metrics.csv") if "train/loss" in r]
    assert len(losses) == 6 and np.isfinite(losses).all()
    _best_loads(run)


def test_cli_train_starts_its_ranks(monkeypatch, tmp_path):
    """``trainer.num_devices=4`` without a group: ``main`` starts 4 gloo ranks
    on the CPU; NCCL needs a card per rank."""
    import climsr_tpu_torch.cli.train as cli

    calls = []
    monkeypatch.setattr(cli, "spawn", lambda *a, **k: calls.append((a, k)))
    cli.main(["--device=cpu", "experiment=esrgan_pre_training", "trainer.num_devices=4"])
    (args, kwargs), = calls
    assert args[:2] == ("climsr_tpu_torch.cli.train:main_rank", 4) and kwargs["backend"] == "gloo"
    assert args[2]["device"] == "cpu" and "trainer.num_devices=4" in args[2]["argv"]
    with pytest.raises(RuntimeError, match="one card per rank"):
        spawn("climsr_tpu_torch.cli.train:main_rank", 2, backend="nccl")


if __name__ == "__main__":  # write RECORD from the JAX package, on the virtual CPU devices of the tests
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import conftest  # noqa: F401  (the JAX platform set-up of the tests)

    np.savez_compressed(RECORD, **jax_spatial_record())
    print(f"wrote {RECORD}")
