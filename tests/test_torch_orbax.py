# -*- coding: utf-8 -*-
"""The port's reader of the JAX package's orbax checkpoints, against the JAX
package, tensorstore, ``zstandard`` and ``google_crc32c`` (which the port
never imports), on the CPU.

- ``io.zstd.decompress`` against ``zstandard`` (hypothesis-drawn inputs,
  levels 1, 3 and 19, with and without the content checksum, inputs over
  128 KB): bytes equal;
- ``io.crc32c`` against ``google_crc32c``: equal;
- ``io.ocdbt.OcdbtStore``: every key and value of a JAX checkpoint (one
  device, and a ZeRO-3 state sharded over the 8 CPU devices) against
  tensorstore's OCDBT kvstore: equal;
- ``interop.orbax.restore_pytree`` against
  ``climsr_tpu.training.checkpoint.restore_pytree``: f32, bf16 (widened to
  f32), int32, ``None`` and empty-tuple leaves, from a manager root, a step
  directory and ``default/``, OCDBT and not: bitwise;
- each generator family at tiny widths from a JAX orbax checkpoint, loaded
  with ``strict=True``: its f32 output against the JAX generator's to 1e-5
  of max|ref|; a GAN state's generator, discriminator (BatchNorm statistics
  included, output to 1e-5 of max|ref|) and both optimizer states;
- resume: for every optimizer name, and with clipping, accumulation and a
  scheduled beta1/momentum, 2 optax updates (3 with accumulation, so the
  accumulator is mid-way) of an SRCNN param tree saved by the JAX package's
  ``CheckpointManager``; the port loads the state and takes the next update:
  parameters against optax's to 1e-6 relative, 2e-6 absolute (f32 rounding
  of the update's order of operations);
- the entry points with ``device="cpu"``: ``cli.inference`` from an orbax
  directory against the JAX package's inference (2e-2 of each month's range:
  both run the generator in bf16), ``cli.train`` grafting
  (``training.model_weights``: the tensors copied and kept fresh are the JAX
  graft's leaves) and resuming (``trainer.resume_from_checkpoint``: at the
  JAX step, with its parameters);
- the committed fixture (``tests/fixtures/jax_orbax_ckpt.tar``, a JAX
  Trainer's checkpoints at the flagship's widths with one RRDB) against the
  JAX restore, bitwise, and its generator on the record's tiles to 1e-5 of
  max|ref|; the full flagship state (nb=11, AdamW) read whole (``slow``).

``python tests/test_torch_orbax.py`` rewrites the fixture and its record
with the JAX package's Trainer and ``CheckpointManager``.
"""
import glob
import tarfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE_TAR = FIXTURES / "jax_orbax_ckpt.tar"
FIXTURE_RECORD = FIXTURES / "jax_orbax_record.npz"
# the fixture's generator: the flagship's widths, one RRDB (chip_smoke.py phase O reads it)
FIXTURE_GEN = dict(nf=64, nb=1, gc=16, in_channels=3, out_channels=1)
REL = 1e-5

FAMILIES = {
    "srcnn": dict(in_channels=3, out_channels=1),
    "esrgan": dict(nf=8, nb=1, gc=8, in_channels=3, out_channels=1),
    "rcan": dict(n_resgroups=1, n_resblocks=2, n_feats=16, reduction=4, out_channels=1),
    "drln": dict(channels=16, in_channels=3, out_channels=1),
    "rfb_esrgan": dict(num_rrdb_blocks=1, num_rrfdb_blocks=1, out_channels=1),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save(root, step, state):
    """``state`` saved as the JAX Trainer saves it."""
    from climsr_tpu.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(root, save_top_k=-1)
    mgr.save(step, state)
    mgr.wait()
    mgr.close()
    return Path(root)


def _flax_params(gtype, kwargs, seed=0):
    """A seeded port generator's weights as the JAX package's param tree
    (its own importer), and the port's ``state_dict``."""
    from climsr_tpu.interop.torch_import import import_generator_params
    from climsr_tpu_torch.models import create_generator

    model = create_generator(gtype, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(seed),
                             **kwargs)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return import_generator_params(gtype, sd, strict=gtype != "drln"), model.state_dict()


def _same(got, want, path=""):
    """``got`` (the port's tree) equals the JAX restore ``want`` bit for bit
    (bf16 widened to f32)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), path


# --------------------------------------------------------------------------- zstd, CRC32C
def _zstd_inputs():
    """Byte strings with literals, matches, runs and repeated offsets."""
    chunk = st.one_of(st.binary(max_size=300), st.binary(min_size=1, max_size=8).map(lambda b: b * 40),
                      st.integers(0, 255).map(lambda v: bytes([v]) * 500))
    return st.lists(chunk, max_size=12).map(b"".join)


@pytest.mark.parametrize("level", [1, 3, 19])
@settings(max_examples=15, deadline=None)
@given(data=_zstd_inputs(), checksum=st.booleans())
def test_zstd_decodes_what_zstandard_writes(level, data, checksum):
    import zstandard

    from climsr_tpu_torch.io import zstd

    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
def test_zstd_large_inputs_match_zstandard(level, checksum):
    """Over 128 KB (several blocks; 4-stream Huffman literals, FSE tables,
    repeat modes): f32 weights, zeros, and text with long matches, as
    concatenated frames behind a skippable one."""
    import zstandard

    from climsr_tpu_torch.io import zstd

    rng = np.random.default_rng(level)
    weights = (rng.normal(size=40_000) * 0.05).astype(np.float32).tobytes()
    text = b"".join(b"key %d value %s; " % (i, str(i * i % 97).encode()) for i in range(9000))
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    skippable = (0x184D2A5A).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frames = c.compress(weights) + skippable + c.compress(bytes(140_000)) + c.compress(text)
    assert len(weights) > 128 * 1024 and len(text) > 128 * 1024
    assert zstd.decompress(frames) == weights + bytes(140_000) + text


def test_zstd_refuses_what_it_does_not_decode():
    import zstandard

    from climsr_tpu_torch.io import zstd

    d = zstandard.ZstdCompressionDict(b"some dictionary content " * 50)
    framed = zstandard.ZstdCompressor(dict_data=d).compress(b"some dictionary content here")
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(framed)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    good = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(b"abc" * 1000))
    good[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(good))


@pytest.mark.parametrize("n", [4, 3, 5, 100])
def test_huffman_stream_must_end_on_its_first_bit(n):
    """Two 1-bit codes (symbols 0 and 1) and the stream 0b1_0110: its end
    marker, then 0, 1, 1, 0 from the top down. Only 4 literals end on the
    stream's first bit; fewer stop above it, more read past it (100 far past
    the buffer's start)."""
    from climsr_tpu_torch.io import zstd

    table = zstd._Huffman([1])  # the last weight (1) is implied
    if n == 4:
        assert zstd._huffman_stream(table, bytes([0b10110]), n) == bytes([0, 1, 1, 0])
    else:
        with pytest.raises(ValueError, match="first bit"):
            zstd._huffman_stream(table, bytes([0b10110]), n)


@pytest.mark.parametrize("n", [0, 1, 9, 4096, 100_003])
def test_crc32c_matches_google_crc32c(n):
    import google_crc32c

    from climsr_tpu_torch.io.crc32c import crc32c

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert crc32c(data) == google_crc32c.value(data)


# --------------------------------------------------------------------------- OCDBT, trees
def _small_state(sharded: bool):
    """An ESRGAN TrainState with AdamW moments (one update on seeded
    gradients); ``sharded``: every leaf with an axis divisible by 8 split over
    the 8 CPU devices (ZeRO-3's layout)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import TrainState as JaxTrainState

    params, _ = _flax_params("esrgan", dict(nf=16, nb=1, gc=8, in_channels=3, out_channels=1))
    tx = jax_build_optimizer(JaxOptimizerConfig(name="adamw", lr=1e-3), lambda s: 1e-3)
    rng = np.random.default_rng(1)
    # optax's AdamW state (traced, not run) with seeded moments
    opt_state = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.random(a.shape).astype(a.dtype)),
                                       jax.eval_shape(tx.init, params))
    state = JaxTrainState(step=jnp.asarray(1, jnp.int32), opt_state=opt_state,
                          params=jax.tree_util.tree_map(jnp.asarray, params))
    if sharded:
        mesh = Mesh(np.array(jax.devices()), ("data",))

        def place(x):
            axes = [i for i, s in enumerate(getattr(x, "shape", ())) if s % 8 == 0]
            spec = [None] * x.ndim
            if axes:
                spec[axes[-1]] = "data"
            return jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))

        state = jax.tree_util.tree_map(place, state)
    return state


@pytest.mark.parametrize("sharded", [False, True], ids=["one_device", "zero3_8_devices"])
def test_ocdbt_store_matches_tensorstore(tmp_path, sharded):
    import tensorstore as ts

    from climsr_tpu_torch.io.ocdbt import OcdbtStore

    root = _save(tmp_path / "ck", 1, _small_state(sharded))
    item = root / "1" / "default"
    store = OcdbtStore(item)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{item}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert store.keys() == sorted(keys) and len(keys) > 40
    for k in keys:
        assert store.read(k) == bytes(kv.read(k).result().value), k
    chunks = [k for k in keys if k.startswith("params.conv_first.Conv_0.kernel/") and not k.endswith(".zarray")]
    assert len(chunks) == (8 if sharded else 1)


def _tree_state():
    """f32, bf16 and int32 arrays, ``None`` leaves, an empty tuple, a list."""
    rng = np.random.default_rng(3)
    return {"step": jnp.asarray(7, jnp.int32),
            "params": {"conv": {"kernel": jnp.asarray(rng.normal(size=(3, 3, 4, 8)).astype(np.float32)),
                                "bias": jnp.zeros(8)},
                       "half": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16)},
            "opt_state": [None, {"count": jnp.asarray(2, jnp.int32), "mu": [jnp.ones(3), jnp.arange(4.0)]},
                          (), None]}


@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt", "files"])
def test_restore_pytree_equals_the_jax_restore(tmp_path, ocdbt):
    import orbax.checkpoint as ocp

    from climsr_tpu.training.checkpoint import restore_pytree as jax_restore
    from climsr_tpu_torch.interop.orbax import is_orbax_checkpoint, restore_pytree

    root = tmp_path / "ck"
    if ocdbt:
        _save(root, 7, _tree_state())
    else:  # the layout of one file per chunk
        ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
        ckptr.save((root / "7" / "default").absolute(), _tree_state())
        assert not (root / "7" / "default" / "manifest.ocdbt").exists()
    want = jax_restore(root)
    for path in (root, root / "7", root / "7" / "default"):
        assert is_orbax_checkpoint(path)
        _same(restore_pytree(path), want)
    got = restore_pytree(root, select="params")  # the subtree alone; bf16 widened to f32 exactly
    _same(got, want["params"])
    assert got["half"].dtype == np.float32
    with pytest.raises(FileNotFoundError, match="neither"):
        restore_pytree(tmp_path)


def test_zarr_layouts_it_does_not_read_raise(tmp_path):
    """zarr v3, an unknown dtype or compressor: ValueError naming it."""
    import json

    from climsr_tpu_torch.interop.orbax import read_arrays
    from climsr_tpu_torch.io.ocdbt import FileStore

    (tmp_path / "a").mkdir()
    meta = {"chunks": [2], "compressor": None, "dtype": "<f4", "fill_value": None, "filters": None,
            "order": "C", "shape": [3], "zarr_format": 2, "dimension_separator": "."}
    (tmp_path / "a" / ".zarray").write_text(json.dumps(meta))
    (tmp_path / "a" / "0").write_bytes(np.array([1, 2], np.float32).tobytes())
    np.testing.assert_array_equal(read_arrays(FileStore(tmp_path), ["a"])["a"], [1, 2, 0])  # chunk 1 missing: fill
    for field, value, match in (("dtype", "<c8", "dtype"), ("compressor", {"id": "blosc"}, "compressor"),
                                ("order", "F", "order"), ("zarr_format", 3, "zarr_format")):
        (tmp_path / "a" / ".zarray").write_text(json.dumps(dict(meta, **{field: value})))
        with pytest.raises(ValueError, match=match):
            read_arrays(FileStore(tmp_path), ["a"])
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "zarr.json").write_text("{}")
    with pytest.raises(ValueError, match="zarr v3"):
        read_arrays(FileStore(tmp_path), ["b"])


@pytest.mark.parametrize("tree", [{"params": {}, "g_params": {"a": 1}}, {"g_params": {"a": 1}, "d_params": {}},
                                  {"conv": {"kernel": 1}}, {"params": {"x": 2}, "opt_state": None}],
                         ids=["empty-params", "gan", "bare", "train-state"])
def test_extract_generator_params_follows_the_jax_rules(tree):
    """Key presence, not truthiness: ``params``, then ``g_params``, else the tree."""
    from climsr_tpu.training.checkpoint import extract_generator_params as jax_extract
    from climsr_tpu_torch.training.checkpoint import extract_generator_params

    assert extract_generator_params(tree) is jax_extract(tree)


# --------------------------------------------------------------------------- generators, GAN state
def _inputs(gtype, rng, n=1, lr=8):
    from climsr_tpu.models import PRE_UPSCALED_GENERATORS

    size = 4 * lr if gtype in PRE_UPSCALED_GENERATORS else lr
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.normal(size=(n, 4 * lr, 4 * lr, 1)).astype(np.float32),
            (rng.random((n, 4 * lr, 4 * lr, 1)) > 0.3).astype(np.float32))


def _jax_out(gtype, kwargs, params, x, elev, mask):
    from climsr_tpu.models import apply_generator
    from climsr_tpu.models import create_generator as jax_create_generator

    model = jax_create_generator(gtype, dtype=jnp.float32, **kwargs)
    return np.asarray(jax.jit(lambda p, *a: apply_generator(gtype, model, {"params": p}, *a))(params, x, elev, mask))


def _port_out(model, gtype, x, elev, mask):
    from climsr_tpu_torch.models import FUSION_GENERATORS

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    args = (nchw(x), nchw(elev), nchw(mask)) if gtype in FUSION_GENERATORS else (nchw(x),)
    with torch.no_grad():
        return model(*args).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("gtype", sorted(FAMILIES))
def test_generator_from_a_jax_checkpoint_loads_strict(tmp_path, gtype):
    """A TrainState of each family saved by the JAX package: the port's
    generator loads it with ``strict=True`` (the family found from its keys)
    and gives the JAX generator's output; the mapping's order is the port
    module's parameter order, which optimizer states rely on."""
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import create_generator

    kwargs = FAMILIES[gtype]
    params, _ = _flax_params(gtype, kwargs)
    root = _save(tmp_path / "ck", 3, JaxTrainState(step=jnp.asarray(3, jnp.int32), opt_state=None,
                                                   params=jax.tree_util.tree_map(jnp.asarray, params)))
    sd = load_generator_checkpoint(root)
    model = create_generator(gtype, dtype=torch.float32, device="cpu", **kwargs)
    assert list(sd) == [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()]
    model.load_state_dict(sd, strict=True)
    x, elev, mask = _inputs(gtype, np.random.default_rng(5))
    want = _jax_out(gtype, kwargs, params, x, elev, mask)
    np.testing.assert_allclose(_port_out(model, gtype, x, elev, mask), want, rtol=0, atol=REL * np.abs(want).max())


def test_gan_state_becomes_the_ports_payload(tmp_path):
    """A GANTrainState (ESRGAN and its discriminator, Adam moments after one
    update each, BatchNorm statistics) -> generator, discriminator with its
    running statistics, and both optimizer states, which the port's
    optimizers load."""
    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.interop.torch_import import import_discriminator_params
    from climsr_tpu.models import create_discriminator as jax_create_discriminator
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import GANTrainState
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_discriminator, create_generator
    from climsr_tpu_torch.training.checkpoint import load_checkpoint
    from climsr_tpu_torch.training.optimizers import build_optimizer

    rng = np.random.default_rng(7)
    g_params, _ = _flax_params("esrgan", FAMILIES["esrgan"])
    d_kwargs = dict(in_channels=1, out_channels=8, num_conv_block=2, hr_size=32)
    d_port = create_discriminator("esrgan", dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(1), **d_kwargs)
    for name, buf in d_port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.from_numpy(rng.random(buf.shape).astype(np.float32) + 0.5))
    d_params, d_stats = import_discriminator_params({k: v.numpy() for k, v in d_port.state_dict().items()})
    tx = jax_build_optimizer(JaxOptimizerConfig(name="adam", lr=1e-3, weight_decay=0.0), lambda s: 1e-3)
    init, update = jax.jit(tx.init), jax.jit(tx.update)
    noise = lambda t: jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), t)  # noqa: E731
    on = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = GANTrainState(step=jnp.asarray(5, jnp.int32), g_params=on(g_params), d_params=on(d_params),
                          g_opt_state=update(noise(g_params), init(g_params))[1],
                          d_opt_state=update(noise(d_params), init(d_params))[1], d_batch_stats=on(d_stats))
    payload = load_checkpoint(_save(tmp_path / "ck", 5, state))
    assert payload["global_step"] == 5
    sd = payload["state_dict"]
    gen = create_generator("esrgan", dtype=torch.float32, device="cpu", **FAMILIES["esrgan"])
    gen.load_state_dict({k[10:]: v for k, v in sd.items() if k.startswith("generator.")}, strict=True)
    disc = create_discriminator("esrgan", dtype=torch.float32, device="cpu", **d_kwargs).eval()
    disc.load_state_dict({k[14:]: v for k, v in sd.items() if k.startswith("discriminator.")}, strict=True)
    assert [k[14:] for k in sd if k.startswith("discriminator.") and "running" not in k and "batches" not in k] \
        == [n for n, _ in disc.named_parameters()]  # the order optimizer states rely on
    for name, buf in d_port.named_buffers():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(disc.get_buffer(name), buf, rtol=0, atol=0)
    hr = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    model = jax_create_discriminator("esrgan", dtype=jnp.float32, in_channels=1, out_channels=8, num_conv_block=2)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": state.d_params, "batch_stats": state.d_batch_stats}, hr))
    with torch.no_grad():
        got = disc(torch.from_numpy(hr).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    for model_, opt_state in zip((gen, disc), payload["optimizer_states"]):
        opt = build_optimizer(OptimizerConfig(name="adam", lr=1e-3), lambda s: 1e-3, device="cpu")(model_.parameters())
        opt.load_state_dict(opt_state)
        assert opt.updates == 1 and len(opt.inner.state) == len(list(model_.parameters()))
    mu = _np(state.d_opt_state[0].mu)
    first = next(iter(payload["optimizer_states"][1]["state"].values()))
    assert first["exp_avg"].shape == disc.feature_extraction[1].weight.shape  # HWIO laid out as OIHW
    np.testing.assert_array_equal(first["exp_avg"].numpy(), mu["block0_conv1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


# --------------------------------------------------------------------------- resume matrix
RESUME = [pytest.param(dict(name=name), {}, id=name)
          for name in ("adam", "fusedadam", "cpuadam", "onebitadam", "adamw", "adamax", "adadelta", "adagrad",
                       "rmsprop", "sgd", "asgd", "rprop")] + [
    pytest.param(dict(name="adam"), dict(gradient_clip_val=0.05), id="adam-clip"),
    pytest.param(dict(name="adamw"), dict(accumulate_grad_batches=2), id="adamw-accumulate2"),
    pytest.param(dict(name="rprop"), dict(accumulate_grad_batches=2, gradient_clip_val=0.05), id="rprop-accumulate2-clip"),
    pytest.param(dict(name="adamw"), dict(b1=True), id="adamw-scheduled-beta1"),
    pytest.param(dict(name="sgd", momentum=0.9), dict(b1=True), id="sgd-scheduled-momentum"),
    pytest.param(dict(name="rmsprop", momentum=0.9), dict(gradient_clip_val=0.05), id="rmsprop-momentum-clip"),
]


@pytest.fixture(scope="module")
def srcnn_params():
    return _flax_params("srcnn", FAMILIES["srcnn"])[0]


@pytest.mark.parametrize("cfg,opts", RESUME)
def test_port_resumes_a_jax_optimizer_state(tmp_path, srcnn_params, cfg, opts):
    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.interop.params import state_dict_from_flax
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.training.checkpoint import load_checkpoint
    from climsr_tpu_torch.training.optimizers import build_optimizer

    rng = np.random.default_rng(11)
    accum = opts.get("accumulate_grad_batches", 1)
    saved = 3 if accum > 1 else 2
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32) * (-1) ** i, srcnn_params)
             for i in range(saved + 1)]
    schedule = lambda s: 1e-2 * (1.0 + 0.1 * s)  # noqa: E731
    b1 = (lambda s: 0.9 - 0.01 * s) if opts.get("b1") else None  # noqa: E731
    kwargs = dict(gradient_clip_val=opts.get("gradient_clip_val", 0.0), accumulate_grad_batches=accum,
                  b1_schedule=b1)
    full = dict(dict(lr=1e-2, weight_decay=1e-2), **cfg)
    tx = jax_build_optimizer(JaxOptimizerConfig(**full), schedule, **kwargs)
    update = jax.jit(lambda g, s, p: (lambda u, s: (jax.tree_util.tree_map(jnp.add, p, u), s))(*tx.update(g, s, p)))
    params = srcnn_params
    opt_state = jax.jit(tx.init)(params)
    for i, g in enumerate(grads):
        if i == saved:
            root = _save(tmp_path / "ck", saved, JaxTrainState(step=jnp.asarray(saved, jnp.int32), params=params,
                                                               opt_state=opt_state))
        params, opt_state = update(g, opt_state, params)

    payload = load_checkpoint(root)
    assert payload["global_step"] == saved
    model = create_generator("srcnn", dtype=torch.float32, device="cpu", **FAMILIES["srcnn"])
    model.load_state_dict({k[10:]: v for k, v in payload["state_dict"].items()}, strict=True)
    opt = build_optimizer(OptimizerConfig(**full), schedule, device="cpu", **kwargs)(model.parameters())
    opt.load_state_dict(payload["optimizer_states"][0])
    assert opt.mini_step == saved % accum
    last = state_dict_from_flax("srcnn", grads[saved])
    for name, p in model.named_parameters():
        p.grad = last[name].clone()
    opt.step()
    want = state_dict_from_flax("srcnn", _np(params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=2e-6, err_msg=name)


def test_optimizer_of_another_family_refuses_the_state(tmp_path, srcnn_params):
    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.training.checkpoint import load_checkpoint
    from climsr_tpu_torch.training.optimizers import build_optimizer

    tx = jax_build_optimizer(JaxOptimizerConfig(name="adagrad"), lambda s: 1e-3)
    payload = load_checkpoint(_save(tmp_path / "ck", 0, JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, srcnn_params), tx)))
    model = create_generator("srcnn", dtype=torch.float32, device="cpu", **FAMILIES["srcnn"])
    opt = build_optimizer(OptimizerConfig(name="adam"), lambda s: 1e-3, device="cpu")(model.parameters())
    with pytest.raises(ValueError, match="adagrad state; this run's optimizer is adam"):
        opt.load_state_dict(payload["optimizer_states"][0])


# --------------------------------------------------------------------------- entry points
def _write_world(root, rng, h=24, w=48, months=2):
    """NetCDF months and elevation/land-mask GeoTIFFs (the JAX package's
    writers), and the min-max / z-score lookups."""
    import pandas as pd

    import climsr_tpu.consts as jconsts
    from climsr_tpu.io import geotiff as jax_geotiff
    from climsr_tpu.io import netcdf as jax_netcdf

    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, : h // 8, :] = np.nan
    time_ = np.array([f"1901-{m:02d}-16" for m in range(1, months + 1)], dtype="datetime64[D]")
    nc = root / "cru_ts4.05.1901.2020.tmp.dat.nc"
    jax_netcdf.write_climate_series(
        nc, jax_netcdf.ClimateSeries("tmp", data, time_, np.linspace(-89, 89, h), np.linspace(-179, 179, w)))
    mask = np.where(rng.random((4 * h, 4 * w)) > 0.5, 1.0, np.nan).astype(np.float32)
    jax_geotiff.write_geotiff(root / "land_mask.tif", mask, jax_geotiff.GeoProfile.global_grid(4 * h, 4 * w))
    elev = rng.normal(500, 300, size=(4 * h, 4 * w)).astype(np.float32)
    elev[0, 0] = jconsts.world_clim.elevation_missing_indicator
    jax_geotiff.write_geotiff(root / "elevation.tif", elev, jax_geotiff.GeoProfile.global_grid(4 * h, 4 * w,
                                                                                                 nodata=None))
    pd.DataFrame([
        {"dataset": "cru-ts", "variable": "tmp", "filename": "tmp_2001-01.tif", "min": 1.0, "max": 20.0,
         "global_min": -3.0, "global_max": 25.0},
        {"dataset": "world-clim", "variable": "tmp", "filename": "tmp_2001-01.tif", "min": 0.0, "max": 1.0,
         "global_min": 0.0, "global_max": 1.0},
    ]).to_feather(root / "min_max.feather")
    pd.DataFrame([{"variable": "tmp", "mean": 10.0, "std": 5.0}]).to_feather(root / "zscore.feather")
    return dict(ds_path=str(nc), tiff_dir=str(root), elevation_file=str(root / "elevation.tif"),
                land_mask_file=str(root / "land_mask.tif"), min_max_lookup=str(root / "min_max.feather"),
                zscore_lookup=str(root / "zscore.feather"))


def test_cli_inference_from_a_jax_checkpoint_matches_jax(tmp_path):
    """``cli.inference``'s ``run`` with ``pretrained_model`` an orbax manager
    root, against the JAX package's ``run_inference`` from the same
    directory. Tolerance: 2e-2 of each month's range (both sides run the
    generator in bf16 and round its intermediates at different places)."""
    from climsr_tpu.config.schemas import InferenceConfig
    from climsr_tpu.inference.run import run_inference as jax_run_inference
    from climsr_tpu.io import geotiff as jax_geotiff
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.cli.inference import run

    params, _ = _flax_params("esrgan", FAMILIES["esrgan"])
    root = _save(tmp_path / "run" / "checkpoints", 4, JaxTrainState(
        step=jnp.asarray(4, jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=None))
    fields = dict(generator_type="esrgan", use_netcdf_datasets=True, pretrained_model=str(root), batch_size=2,
                  tile_size=16, tile_overlap=4, **_write_world(tmp_path, np.random.default_rng(2)))
    gen_kwargs = dict(nf=8, nb=1, gc=8, out_channels=1)
    jax_run_inference(InferenceConfig(inference_out_path=str(tmp_path / "jax"), **fields), ["tmp"], gen_kwargs)
    cfg = SimpleNamespace(**{**vars(InferenceConfig(**fields)), "inference_out_path": str(tmp_path / "port"),
                             "cruts_variable": "tmp", "run_inference": True, "to_netcdf": False})
    run(cfg, gen_kwargs, device="cpu")
    want = sorted((tmp_path / "jax" / "tmp").glob("*.tif"))
    got = sorted((tmp_path / "port" / "tmp").glob("*.tif"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 2
    for a, b in zip(got, want):
        a, b = jax_geotiff.read_geotiff(a)[0], jax_geotiff.read_geotiff(b)[0]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        land = ~np.isnan(b)
        np.testing.assert_allclose(a[land], b[land], rtol=0, atol=2e-2 * (np.nanmax(b) - np.nanmin(b)))


TRAIN = [
    "experiment=esrgan_pre_training", "generator.nf=8", "generator.nb=2", "generator.gc=8",
    "training.batch_size=2", "training.validation_batch_size=2", "training.num_workers=1",
    "trainer.max_epochs=1", "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
    "trainer.log_every_n_steps=1", "trainer.precision=fp32", "trainer.device_augment=false", "logger=csv",
    "print_config=false", "training.run_test_after_fit=false",
]


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("ds")
    make_synthetic_dataset(root, n_tiles_per_stage=(2, 2, 2))
    return root


def _train(world, out, *extra):
    """``cli.train`` on the CPU; the Trainer it built."""
    from climsr_tpu_torch.cli.train import main
    from climsr_tpu_torch.training import loop

    built = []
    init = loop.Trainer.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    loop.Trainer.__init__ = keep
    try:
        main(["--device=cpu", *TRAIN, f"datamodule.cfg.data_path={world}", f"training.output_dir={out}", *extra])
    finally:
        loop.Trainer.__init__ = init
    return built[0]


def test_cli_train_grafts_a_jax_checkpoint(tiny_world, tmp_path):
    """``training.model_weights=<orbax root>`` of a 1-RRDB ESRGAN into a
    2-RRDB one: the tensors copied and kept fresh are the leaves the JAX
    graft copies and keeps fresh, and the copied ones hold the checkpoint's
    values."""
    from climsr_tpu.training import checkpoint as jax_ckpt
    from climsr_tpu.training.train_state import TrainState as JaxTrainState

    params, port_sd = _flax_params("esrgan", FAMILIES["esrgan"])
    root = _save(tmp_path / "jax" / "checkpoints", 2, JaxTrainState(
        step=jnp.asarray(2, jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=None))
    fresh, _ = _flax_params("esrgan", dict(FAMILIES["esrgan"], nb=2), seed=9)
    _, n_copied, n_fresh = jax_ckpt._graft(fresh, dict(jax_ckpt._flatten(params)), ())
    trainer = _train(tiny_world, tmp_path / "port", f"training.model_weights={root}", "training.run_fit=false",
                     "training.run_test_after_fit=true", "trainer.limit_test_batches=1")
    copied, total = trainer.graft
    assert (copied, total - copied) == (n_copied, n_fresh) and n_fresh > 0
    sd = trainer.g_model.state_dict()
    for k, v in port_sd.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_cli_train_resumes_a_jax_checkpoint(tiny_world, tmp_path):
    """``trainer.resume_from_checkpoint=<orbax root>`` (an AdamW TrainState
    at step 6, as the preset builds it): the Trainer starts at the JAX step
    with its parameters and optimizer state, takes one step and saves step 7."""
    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.training import loop
    from climsr_tpu_torch.training.checkpoint import load_checkpoint

    params, port_sd = _flax_params("esrgan", dict(FAMILIES["esrgan"], nb=2))
    tx = jax_build_optimizer(JaxOptimizerConfig(name="adamw", lr=1e-4), lambda s: 1e-4, b1_schedule=lambda s: 0.9)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    state = JaxTrainState(step=jnp.asarray(6, jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                          opt_state=jax.jit(tx.update)(grads, jax.jit(tx.init)(params), params)[1])
    root = _save(tmp_path / "jax" / "checkpoints", 6, state)

    loaded = []
    load = loop.Trainer._load_payload

    def keep(self, ckpt):
        load(self, ckpt)
        loaded.append((self.global_step, {k: v.clone() for k, v in self.g_model.state_dict().items()},
                       self._optimizers()[0][0].updates))

    loop.Trainer._load_payload = keep
    try:
        _train(tiny_world, tmp_path / "port", f"trainer.resume_from_checkpoint={root}", "trainer.save_top_k=-1")
    finally:
        loop.Trainer._load_payload = load
    (step, sd, updates), = loaded
    assert step == 6 and updates == 1
    for k, v in port_sd.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    (run,) = glob.glob(f"{tmp_path}/port/outputs/runs/esrgan/*")
    assert load_checkpoint(f"{run}/checkpoints")["global_step"] == 7


# --------------------------------------------------------------------------- the fixture, the flagship
@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixture")
    with tarfile.open(FIXTURE_TAR) as tar:
        tar.extractall(out, filter="data")
    return out / "checkpoints"


def test_fixture_reads_as_the_jax_restore_and_its_record(fixture_root):
    """The committed fixture: the port's tree equals the JAX restore bit for
    bit, and the generator it holds gives the record's JAX output on the
    record's two seeded 32x32 tiles (1e-5 of max|ref|)."""
    from climsr_tpu.training.checkpoint import restore_pytree as jax_restore
    from climsr_tpu_torch.interop.orbax import restore_pytree
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import create_generator

    assert FIXTURE_TAR.stat().st_size + FIXTURE_RECORD.stat().st_size < 2.5e6
    record = np.load(FIXTURE_RECORD)
    tree = restore_pytree(fixture_root)
    _same(tree, jax_restore(fixture_root))
    assert int(tree["step"]) == int(record["step"])
    model = create_generator("esrgan", dtype=torch.float32, device="cpu", **FIXTURE_GEN)
    model.load_state_dict(load_generator_checkpoint(fixture_root), strict=True)
    x, elev, mask = record_inputs()["tiles"]
    np.testing.assert_allclose(_port_out(model, "esrgan", x, elev, mask), record["jax_out"], rtol=0,
                               atol=REL * np.abs(record["jax_out"]).max())


def record_inputs():
    """The record's inputs, made from seed 0: two 32x32 LR tiles (3
    channels) with 128x128 elevation and mask, and a batch of two with HR."""
    rng = np.random.default_rng(0)
    tiles = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32), rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             (rng.random((2, 128, 128, 1)) > 0.3).astype(np.float32))
    batch = {"lr": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             "hr": rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             "elevation": rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             "mask": (rng.random((2, 128, 128, 1)) > 0.3).astype(np.float32)}
    return {"tiles": tiles, "batch": batch}


@pytest.mark.slow  # ~20 s with the JAX side: 47 MB of random f32 written, read by the port and by JAX
def test_flagship_adamw_state_is_read_whole(tmp_path):
    """The JAX TrainState of the flagship (nf=64, nb=11, gc=16; 4,278,530
    generator parameters) with AdamW's moments filled with seeded values,
    read whole by the port: bitwise the JAX restore. The seconds are
    printed."""
    from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
    from climsr_tpu.training.checkpoint import restore_pytree as jax_restore
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.interop.orbax import restore_pytree

    params, _ = _flax_params("esrgan", dict(nf=64, nb=11, gc=16, in_channels=3, out_channels=1))
    assert sum(p.size for p in jax.tree_util.tree_leaves(params)) == 4_278_530
    tx = jax_build_optimizer(JaxOptimizerConfig(name="adamw", lr=1e-4), lambda s: 1e-4)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    rng = np.random.default_rng(0)
    state = state.replace(opt_state=jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.normal(size=x.shape)).astype(np.float32) * 1e-3)
        if x.dtype == jnp.float32 else x, state.opt_state))
    root = _save(tmp_path / "ck", 100, state)
    t = time.perf_counter()
    tree = restore_pytree(root)
    seconds = time.perf_counter() - t
    t = time.perf_counter()
    restore_pytree(root, select="params")
    generator_s = time.perf_counter() - t
    print(f"flagship AdamW state ({sum(f.stat().st_size for f in root.rglob('*') if f.is_file()) / 1e6:.1f} MB "
          f"on disk) read whole in {seconds:.2f} s, its generator alone in {generator_s:.2f} s")
    _same(tree, jax_restore(root))


# --------------------------------------------------------------------------- rewriting the fixture
def _write_fixture():
    """The JAX Trainer (``climsr_tpu.training.loop``) at the fixture's widths
    with SGD (no momentum, no decay: no moments) on a tiny synthetic set, 2
    steps and a validation; its checkpoint directory tarred, and the record:
    the JAX generator's f32 output on the record's tiles and the JAX
    pre-training step's loss on the record's batch from the saved state."""
    import io
    import tempfile

    from climsr_tpu.cli.train import _flatten_task_cfg as flatten
    from climsr_tpu.config import schemas
    from climsr_tpu.config.compose import compose
    from climsr_tpu.data.datamodule import SuperResolutionDataModule
    from climsr_tpu.models import create_generator as jax_create_generator
    from climsr_tpu.training.checkpoint import restore_pytree as jax_restore
    from climsr_tpu.training.loop import Trainer
    from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from climsr_tpu.training.tasks.pretrain import make_pretrain_step as jax_make_pretrain_step
    from climsr_tpu.training.train_state import TrainState as JaxTrainState
    from climsr_tpu_torch.config.compose import default_config_dir
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_dataset(tmp / "ds", n_tiles_per_stage=(4, 2, 2))
        overrides = ["experiment=esrgan_pre_training", "generator.nf=64", "generator.nb=1", "generator.gc=16",
                     "optimizers.generator_optimizer.name=sgd", "optimizers.generator_optimizer.weight_decay=0",
                     "training.batch_size=2", "training.validation_batch_size=2", "training.num_workers=1",
                     "trainer.max_epochs=1", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
                     "trainer.precision=fp32", "trainer.device_augment=false", "trainer.num_devices=1",
                     "logger=csv", f"datamodule.cfg.data_path={tmp / 'ds'}"]
        cfg = compose(default_config_dir(), "config", overrides)
        data_cfg = schemas.from_dict(schemas.SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
        gen = schemas.infer_generator_config(schemas.from_dict(schemas.GeneratorConfig, cfg["generator"]), data_cfg)
        trainer = Trainer(
            datamodule=SuperResolutionDataModule(data_cfg), generator_cfg=gen,
            task_cfg=schemas.from_dict(schemas.TaskConfig, flatten(cfg["task"])),
            trainer_cfg=schemas.from_dict(schemas.TrainerConfig, cfg["trainer"]),
            training_cfg=schemas.from_dict(schemas.TrainingConfig, cfg["training"]),
            optimizers={k: schemas.from_dict(schemas.OptimizerConfig, v) for k, v in cfg["optimizers"].items()},
            schedulers={k: schemas.from_dict(schemas.SchedulerConfig, v) for k, v in cfg["schedulers"].items()},
            workdir=tmp / "run", logger_cfg="csv")
        try:
            trainer.fit()
        finally:
            trainer.close()
        ckpt = tmp / "run" / "checkpoints"
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w", format=tarfile.PAX_FORMAT) as tar:
            for path in sorted(ckpt.rglob("*")):
                info = tar.gettarinfo(str(path), arcname=str(Path("checkpoints") / path.relative_to(ckpt)))
                info.mtime, info.uid, info.gid, info.uname, info.gname = 0, 0, 0, "", ""
                if path.is_file():
                    with open(path, "rb") as f:
                        tar.addfile(info, f)
                else:
                    tar.addfile(info)
        FIXTURE_TAR.write_bytes(buf.getvalue())
        tree = jax_restore(ckpt)
        model = jax_create_generator("esrgan", dtype=jnp.float32, use_pallas=False, **FIXTURE_GEN)
        inputs = record_inputs()
        x, elev, mask = inputs["tiles"]
        jax_out = np.asarray(model.apply({"params": tree["params"]}, x, elev, mask))
        tx = jax_build_optimizer(schemas.OptimizerConfig(name="sgd", lr=1e-4, weight_decay=0.0), lambda s: 1e-4)
        state = JaxTrainState.create(tree["params"], tx)
        step = jax_make_pretrain_step(model, "esrgan", tx, compute_dtype=jnp.float32, donate=False)
        _, metrics = step(state, {k: jnp.asarray(v) for k, v in inputs["batch"].items()})
        np.savez(FIXTURE_RECORD, jax_out=jax_out, loss=np.float64(metrics["train/loss"]), step=int(tree["step"]))
    print(f"wrote {FIXTURE_TAR} ({FIXTURE_TAR.stat().st_size} bytes) and {FIXTURE_RECORD}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _write_fixture()
