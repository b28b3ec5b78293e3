# -*- coding: utf-8 -*-
"""The port's data path against the JAX package's, on the CPU.

- ``make_synthetic_dataset``: the same tiles bit for bit from one seed, and
  the same index tables (as written to feather by both packages);
- ``resize_cubic`` against ``cv2.INTER_CUBIC`` (to 1e-6 absolute plus 1e-6
  relative: float32 sums in another order, a few float32 steps);
- ``ClimateDataset`` through ``SuperResolutionDataModule``: train samples bit
  for bit (the host augmentation draws from the same numpy RNG), val/test
  samples bit for bit but the cubic baseline (tolerance as above);
- the loaders' batch order equals the JAX loaders';
- ``augment_and_assemble`` equals the JAX function with explicit flags, for
  all 16 flip/rotation combinations, exactly;
- the device stores gathered by index equal the host batches, exactly;
- :class:`Table` against pandas for the operations the data path uses.
"""
import itertools
import warnings

import numpy as np
import pytest
import torch

from climsr_tpu.config import schemas as jax_schemas
from climsr_tpu.data import pipeline as jax_pipeline
from climsr_tpu.data.datamodule import SuperResolutionDataModule as JaxDataModule
from climsr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from climsr_tpu_torch.config import schemas
from climsr_tpu_torch.data import pipeline
from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule
from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
from climsr_tpu_torch.data.tables import Table, as_table, read_feather

torch.set_num_threads(1)
warnings.filterwarnings("ignore", category=FutureWarning)

TILES = (6, 2, 2)
CUBIC_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The same seed through both factories; the port's tables too."""
    root = tmp_path_factory.mktemp("worlds")
    jax_make_synthetic_dataset(root / "jax", n_tiles_per_stage=TILES, seed=3)
    tables = make_synthetic_dataset(root / "port", n_tiles_per_stage=TILES, seed=3)
    return root / "jax", root / "port", tables


def _data_cfgs(path, **kw):
    fields = {**dict(data_path=str(path), resolutions=["2.5m"], batch_size=4, validation_batch_size=4,
                     num_workers=2, generator_type="esrgan", use_global_min_max=False), **kw}
    return schemas.SuperResolutionDataConfig(**fields), jax_schemas.SuperResolutionDataConfig(**fields)


def _nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2) if np.ndim(a) == 4 else np.asarray(a)


def test_synthetic_dataset_matches_jax(worlds):
    jax_root, port_root, tables = worlds
    jax_files = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
    assert jax_files == sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
    feathers = [f for f in jax_files if f.suffix == ".feather"]
    assert len(feathers) == len(tables) == 12
    for rel in jax_files:
        if rel.suffix == ".tif":
            assert (jax_root / rel).read_bytes() == (port_root / rel).read_bytes(), rel
    for rel in feathers:
        want = read_feather(jax_root / rel)
        key = rel.relative_to("pre-processed/feather").as_posix()
        for got in (read_feather(port_root / rel), tables[key]):
            assert got.columns == want.columns, rel
            for c in want.columns:
                w = want[c]
                if w.dtype == object:
                    w = np.asarray([str(v).replace(str(jax_root), str(port_root)) for v in w], object)
                assert got[c].dtype == w.dtype, (rel, c)
                np.testing.assert_array_equal(got[c], w, err_msg=f"{rel}:{c}")


def test_synthetic_dataset_without_index_writes_only_tiles(tmp_path):
    tables = make_synthetic_dataset(tmp_path, n_tiles_per_stage=(2, 1, 1), write_index=False)
    assert not (tmp_path / "pre-processed").exists()
    assert set(tables) >= {"elev/elev.feather", "statistics_min_max.feather", "tmin/train.feather"}


@pytest.mark.parametrize("shape", [(32, 32, 128, 128), (29, 45, 116, 180), (8, 8, 3, 5), (113, 113, 452, 452)])
def test_resize_cubic_matches_cv2(shape):
    import cv2

    from climsr_tpu_torch.ops.resize import resize_cubic

    h, w, dh, dw = shape
    img = np.random.default_rng(0).uniform(-1, 1, (h, w)).astype(np.float32)
    img[h // 2, w // 3] = np.nan
    want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(img, dh, dw)
    assert got.dtype == np.float32 and np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **CUBIC_TOL)


@pytest.mark.parametrize("generator_type,method", [("esrgan", "minmax"), ("srcnn", "zscore"), ("esrgan", "zscore")])
def test_datamodule_samples_match_jax(worlds, generator_type, method):
    jax_root, port_root, tables = worlds
    cfg, jcfg = _data_cfgs(jax_root, generator_type=generator_type, normalization_method=method)
    want = JaxDataModule(jcfg)
    for got in (SuperResolutionDataModule(cfg), SuperResolutionDataModule(cfg, tables=tables)):
        assert len(got.train_dataset) == len(want.train_dataset) == 3 * TILES[0]
        assert [len(d) for d in got.test_datasets] == [len(d) for d in want.test_datasets] == [TILES[2]] * 3
        got.train_dataset.set_epoch(7)
        want.train_dataset.set_epoch(7)
        for i in range(len(want.train_dataset)):
            a, b = want.train_dataset[i], got.train_dataset[i]
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"train[{i}].{k}")
        for jds, ds in [(want.val_dataset, got.val_dataset)] + list(zip(want.test_datasets, got.test_datasets)):
            for i in range(len(jds)):
                a, b = jds[i], ds[i]
                assert list(a) == list(b)
                for k in a:
                    if k == "cubic":
                        np.testing.assert_allclose(b[k], a[k], **CUBIC_TOL)
                    else:
                        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if method == "zscore":
        stats = want.zscore_df.set_index("variable")
        assert got.zscore_stats("temp") == (float(stats.at["tmp", "mean"]), float(stats.at["tmp", "std"]))


def test_loaders_keep_the_jax_order(worlds):
    """Train batches (shuffled, drop-last), padded val batches, raw tiles and
    index batches, over two epochs: the JAX loaders' batches, exactly (the
    cubic baseline to its tolerance)."""
    jax_root, _, tables = worlds
    cfg, jcfg = _data_cfgs(jax_root, validation_batch_size=5)
    dm, jdm = SuperResolutionDataModule(cfg, tables=None), JaxDataModule(jcfg)
    pairs = [
        (pipeline.DataLoader(dm.train_dataset, 4, shuffle=True, num_workers=3, seed=5),
         jax_pipeline.DataLoader(jdm.train_dataset, 4, shuffle=True, num_workers=3, seed=5)),
        (pipeline.DataLoader(dm.val_dataset, 5, shuffle=False, drop_last=False, pad_last=True, num_workers=2),
         jax_pipeline.DataLoader(jdm.val_dataset, 5, shuffle=False, drop_last=False, pad_last=True, num_workers=2)),
        (pipeline.RawTileLoader(dm.train_dataset, 4, num_workers=2, seed=5),
         jax_pipeline.RawTileLoader(jdm.train_dataset, 4, num_workers=2, seed=5)),
        (pipeline.EpochIndexSampler(18, 4, seed=5), jax_pipeline.EpochIndexSampler(18, 4, seed=5)),
    ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                if isinstance(w, dict):
                    assert list(g) == list(w)
                    for k in w:
                        if k == "cubic":
                            np.testing.assert_allclose(g[k], w[k], **CUBIC_TOL)
                        else:
                            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vflip,hflip,k", list(itertools.product([False, True], [False, True], range(4))))
def test_augment_and_assemble_matches_jax_with_explicit_flags(vflip, hflip, k):
    import jax
    import jax.numpy as jnp

    from climsr_tpu.ops.augment import _apply_flips_rot, assemble_train_inputs as jax_assemble
    from climsr_tpu_torch.ops.augment import augment_and_assemble

    rng = np.random.default_rng(k + 4 * hflip + 8 * vflip)
    raw = {"hr": rng.normal(size=(2, 16, 16, 1)).astype(np.float32),
           "elevation": rng.normal(size=(2, 16, 16, 1)).astype(np.float32),
           "mask": (rng.random((2, 16, 16, 1)) > 0.3).astype(np.float32)}
    # sample 0 takes the case's flags, sample 1 the identity
    v, h, kk = np.array([vflip, False]), np.array([hflip, False]), np.array([k, 0], np.int32)
    aug = [jax.vmap(_apply_flips_rot)(jnp.asarray(raw[key]), v, h, kk) for key in ("hr", "elevation", "mask")]
    flags = (torch.from_numpy(v), torch.from_numpy(h), torch.from_numpy(kk.astype(np.int64)))
    batch = {key: pipeline.to_nchw(val) for key, val in raw.items()}
    for generator_type in ("esrgan", "srcnn"):
        for use_elevation, use_mask in ((True, True), (False, True)):
            got = augment_and_assemble(batch, None, generator_type, scale=4, use_elevation=use_elevation,
                                       use_mask=use_mask, flags=flags)
            want = dict(zip(("hr", "elevation", "mask"), aug))
            want["lr"] = jax_assemble(*aug, generator_type, 4, use_elevation, use_mask)
            assert set(got) == set(want)
            for key, w in want.items():
                np.testing.assert_array_equal(got[key].numpy(), _nchw(w), err_msg=f"{generator_type}:{key}")


def test_augment_draws_follow_the_step_seed():
    from climsr_tpu_torch.ops.augment import draw_flags, step_generator

    a = draw_flags(4096, step_generator(42, 3, torch.device("cpu")))
    b = draw_flags(4096, step_generator(42, 3, torch.device("cpu")))
    c = draw_flags(4096, step_generator(42, 4, torch.device("cpu")))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[2], c[2])
    v, h, k = a
    assert abs(v.float().mean() - 0.5) < 0.05 and abs(h.float().mean() - 0.5) < 0.05
    # no rotation w.p. 1/2 + 1/8; each of k = 1, 2, 3 w.p. 1/8
    np.testing.assert_allclose(torch.bincount(k, minlength=4).numpy() / 4096, [0.625, 0.125, 0.125, 0.125],
                               atol=0.03)
    off = draw_flags(64, step_generator(0, 0, torch.device("cpu")), v_flip=False, h_flip=False,
                     random_90_rotation=False)
    assert not off[0].any() and not off[1].any() and not off[2].any()


def test_device_stores_match_the_host_batches(worlds):
    """``build_device_store`` gathered by the sampler's indices equals the
    raw-tile loader's batches; ``build_eval_device_store`` equals the val
    loader's batches (less the keys the eval step does not read); and the
    train step's ``prepare_batch`` gathers and augments from the store."""
    from climsr_tpu_torch.training.tasks.pretrain import prepare_batch

    _, _, tables = worlds
    cfg, _ = _data_cfgs("unused")
    dm = SuperResolutionDataModule(cfg, tables=tables)
    store = pipeline.build_device_store(dm.train_dataset, num_workers=2, device="cpu")
    sampler = pipeline.EpochIndexSampler(len(dm.train_dataset), 4, seed=9)
    raw = pipeline.RawTileLoader(dm.train_dataset, 4, num_workers=2, seed=9)
    for idx, host in zip(sampler, raw):
        got = pipeline.gather(store, torch.from_numpy(idx))
        for k, v in host.items():
            np.testing.assert_array_equal(got[k].numpy(), _nchw(v), err_msg=k)
        kwargs = dict(scale=4, use_elevation=True, use_mask=True)
        batch = prepare_batch(idx, 5, "esrgan", kwargs, 42, store)
        assert batch["lr"].shape == (4, 3, 32, 32) and batch["hr"].shape == (4, 1, 128, 128)
        np.testing.assert_array_equal(batch["lr"][:, :1].numpy(), batch["hr"][:, :, ::4, ::4].numpy())
    eval_store = pipeline.build_eval_device_store(dm.val_dataset, num_workers=2, device="cpu")
    assert set(eval_store) == set(dm.val_dataset[0]) - set(pipeline.EVAL_STORE_SKIP)
    loader = pipeline.DataLoader(dm.val_dataset, 4, shuffle=False, drop_last=False, pad_last=True, num_workers=2)
    for start, host in zip(range(0, len(dm.val_dataset), 4), pipeline.device_prefetch(iter(loader), "cpu")):
        idx = torch.arange(start, min(start + 4, len(dm.val_dataset)))
        got = pipeline.gather(eval_store, idx)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), host[k][: len(idx)].numpy(), err_msg=k)


def test_table_matches_pandas():
    import pandas as pd

    left = pd.DataFrame({"f": ["a", "b", "c", "d"], "y": [2001, 2030, 2002, 2003], "r": ["2.5m", "5m", "2.5m", "2.5m"],
                         "v": [1.0, 2.0, 3.0, 4.0]})
    right = pd.DataFrame({"f": ["d", "a", "c", "a"], "y": [2003, 2001, 2002, 2001], "min": [0.1, 0.2, 0.3, 0.4]})
    t, u = as_table(left), as_table(right)
    kept = t.filter((t["y"] <= 2020) & t.isin("r", ["2.5m"]))
    want = left[(left["y"] <= 2020) & left["r"].isin(["2.5m"])]
    assert kept.columns == list(want.columns) and kept["f"].tolist() == want["f"].tolist()
    merged, want = kept.merge(u, on=["f", "y"]), pd.merge(want, right, how="inner", on=["f", "y"])
    assert merged.columns == list(want.columns)
    for c in want.columns:
        assert merged[c].tolist() == want[c].tolist(), c
    both = Table.concat([kept, kept])
    assert both["v"].tolist() == pd.concat([left.iloc[[0, 2, 3]]] * 2)["v"].tolist()
    assert t.lookup("f", "c", "v") == left.set_index("f").at["c", "v"]
    assert t.drop(["v"]).columns == ["f", "y", "r"] and t.row(1)["y"] == 2030
    with pytest.raises(KeyError):
        t.lookup("f", "zz", "v")
