# -*- coding: utf-8 -*-
"""The port's models (climsr_tpu_torch.models) against the JAX package's.

Same numpy inputs, the JAX params carried over by ``state_dict_from_flax``,
f32 on the CPU. Tolerance: 1e-4 of max|ref| unless stated (summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.interop.torch_import import export_generator_params
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.models.common import TorchConv as JaxTorchConv
from climsr_tpu.models.srcnn import SRCNN as JaxSRCNN
from climsr_tpu.ops.fused_upsample_conv import nearest_up2_conv3 as jax_nearest_up2_conv3
from climsr_tpu_torch.interop.params import load_generator_checkpoint, state_dict_from_flax
from climsr_tpu_torch.models import SRCNN, apply_generator, create_generator
from climsr_tpu_torch.models.common import TorchConv, init_torch_default_
from climsr_tpu_torch.ops.fused_upsample_conv import nearest_up2_conv3
from climsr_tpu_torch.ops.rdb import fused_rdb

torch.set_num_threads(1)

REL_TOL = 1e-4


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _assert_close(got_nchw: torch.Tensor, want_nhwc, rel=REL_TOL):
    want = np.asarray(want_nhwc)
    got = got_nchw.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("k,padding", [(3, None), (9, 4), (1, 0), (5, 2)])
def test_torch_conv_matches_jax(rng, k, padding):
    x = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    mod = JaxTorchConv(7, kernel_size=k, padding=padding)
    v = mod.init(jax.random.PRNGKey(0), x)
    conv = TorchConv(5, 7, kernel_size=k, padding=padding)
    kp = v["params"]["Conv_0"]
    conv.load_state_dict({
        "weight": torch.from_numpy(np.asarray(kp["kernel"]).transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(np.array(kp["bias"])),
    })
    with torch.no_grad():
        _assert_close(conv(_nchw(x)), mod.apply(v, x))


def test_torch_conv_init_is_torch_default_from_the_generator():
    a = init_torch_default_(TorchConv(6, 4, 3), torch.Generator().manual_seed(3))
    b = init_torch_default_(TorchConv(6, 4, 3), torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
    bound = 1 / np.sqrt(6 * 9)
    assert a.weight.abs().max() <= bound and a.bias.abs().max() <= bound
    assert a.weight.abs().max() > 0.5 * bound
    assert TorchConv(6, 4, 3).weight.abs().max() == 0  # no draw without a generator


def test_nearest_up2_conv3_matches_jax_phase_decomposition(rng):
    x = rng.normal(size=(2, 6, 7, 8)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 8, 5)).astype(np.float32) * 0.2
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = jax_nearest_up2_conv3(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    got = nearest_up2_conv3(
        _nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias)
    )
    _assert_close(got, want)


def test_srcnn_matches_jax(rng):
    x = rng.normal(size=(2, 12, 10, 3)).astype(np.float32)
    mod = JaxSRCNN(in_channels=3, out_channels=1)
    v = mod.init(jax.random.PRNGKey(1), x)
    model = SRCNN(in_channels=3, out_channels=1)
    model.load_state_dict(state_dict_from_flax("srcnn", _np_tree(v["params"])), strict=True)
    with torch.no_grad():
        _assert_close(model(_nchw(x)), mod.apply(v, x))


def _esrgan_case(rng, nf, nb, gc, h, w, use_pallas=False):
    m = jax_create_generator("esrgan", nf=nf, nb=nb, gc=gc, out_channels=1, use_pallas=use_pallas)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    e = rng.normal(size=(2, 4 * h, 4 * w, 1)).astype(np.float32)
    mask = (rng.random((2, 4 * h, 4 * w, 1)) > 0.3).astype(np.float32)
    v = m.init(jax.random.PRNGKey(0), x, e, mask)
    port = create_generator("esrgan", nf=nf, nb=nb, gc=gc, out_channels=1, device="cpu")
    port.load_state_dict(state_dict_from_flax("esrgan", _np_tree(v["params"])), strict=True)
    return m, v, port, (x, e, mask)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas-interpret"])
def test_esrgan_matches_jax(rng, use_pallas):
    """nf=16, nb=2, gc=8 at 8x16 LR (a Pallas-eligible tile: 128 lanes)."""
    m, v, port, args = _esrgan_case(rng, 16, 2, 8, 8, 16, use_pallas)
    with torch.inference_mode():
        got = port(*(_nchw(a) for a in args))
    _assert_close(got, m.apply(v, *args))


def test_esrgan_flagship_width_one_block_matches_jax(rng):
    m, v, port, args = _esrgan_case(rng, 64, 1, 16, 8, 8)
    with torch.inference_mode():
        got = apply_generator("esrgan", port, *(_nchw(a) for a in args))
    _assert_close(got, m.apply(v, *args))


def test_esrgan_reference_default_width_one_block_matches_jax(rng):
    """GeneratorConfig's widths (nf=64, gc=32), one RRDB, 8x8 LR: the width the
    bf16 chain takes at 8 x 16 tiles on the card."""
    m, v, port, args = _esrgan_case(rng, 64, 1, 32, 8, 8)
    with torch.inference_mode():
        got = apply_generator("esrgan", port, *(_nchw(a) for a in args))
    _assert_close(got, m.apply(v, *args))


def test_state_dict_from_flax_equals_export_generator_params(rng):
    """Array for array, the JAX package's own export of the same params."""
    for name, nb in (("esrgan", 2), ("srcnn", None)):
        kwargs = dict(nf=16, nb=nb, gc=8, out_channels=1) if nb else dict(out_channels=1)
        m = jax_create_generator(name, use_pallas=False, **kwargs) if nb else JaxSRCNN(in_channels=3)
        x = jnp.zeros((1, 8, 8, 3))
        args = (x, jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 1))) if nb else (x,)
        params = m.init(jax.random.PRNGKey(2), *args)["params"]
        sd = state_dict_from_flax(name, _np_tree(params))
        want = export_generator_params(name, params)
        assert sorted(sd) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(sd[k].numpy(), want[k])


def test_esrgan_state_dict_keys_are_the_reference_keys():
    port = create_generator("esrgan", nf=16, nb=2, gc=8, out_channels=1, device="cpu")
    keys = set(port.state_dict())
    for k in ("conv_first.weight", "RRDB_trunk.1.RDB3.conv5.bias", "trunk_conv.weight", "upconv1.weight",
              "upconv2.weight", "HRconv.weight", "conv_last.bias", "srcnn.conv1.weight", "srcnn.conv3.bias"):
        assert k in keys
    assert len(keys) == 2 * (1 + 2 * 15 + 5 + 3)


def test_rdb_modules_pack_once_and_repack_on_update():
    port = create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=1, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    blk = port.RRDB_trunk[0].RDB1
    p1 = blk.packed_weights(torch.float32)
    assert blk.packed_weights(torch.float32) is p1
    with torch.no_grad():
        blk.conv2.weight.add_(1.0)
    p2 = blk.packed_weights(torch.float32)
    assert p2 is not p1 and not torch.equal(p1.w, p2.w)


def test_esrgan_on_cpu_never_counts_a_launch(rng):
    port = create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=1, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    fused_rdb.launches = 0
    with torch.inference_mode():
        out = port(torch.zeros(1, 3, 4, 4), torch.zeros(1, 1, 16, 16), torch.ones(1, 1, 16, 16))
    assert out.shape == (1, 1, 16, 16) and fused_rdb.launches == 0


@pytest.mark.parametrize("name", ["rcan", "drln", "rfb_esrgan"])
def test_unported_generators_name_their_roadmap_item(name):
    """The families ``ROADMAP.md`` queue 1 item 7 listed are ported now: each
    builds from the registry at its ``conf/generator`` defaults, its
    JAX-only config keys dropped (``tests/test_torch_generators.py`` holds
    them against the JAX package)."""
    model = create_generator(name, device="cpu", in_channels=3, out_channels=1, scaling_factor=4, remat=True,
                             use_pallas=None)
    assert sum(p.numel() for p in model.parameters()) > 0
    assert next(model.parameters()).is_contiguous(memory_format=torch.channels_last)


def test_create_generator_drops_jax_only_config_keys():
    model = create_generator("esrgan", device="cpu", nf=8, nb=1, gc=8, out_channels=1,
                             use_pallas=True, remat=True, fused_upsample=False)
    assert len(model.RRDB_trunk) == 1
    assert model.conv_first.weight.is_contiguous(memory_format=torch.channels_last)


def test_load_generator_checkpoint_reads_a_pl_ckpt(tmp_path, rng):
    """A reference PL checkpoint: ``generator.``-prefixed weights beside the
    discriminator's and other entries; loads with strict=True."""
    src = create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    sd = {f"generator.{k}": v for k, v in src.state_dict().items()}
    sd["discriminator.classification.0.weight"] = torch.zeros(2, 2)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    dst = create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, device="cpu")
    dst.load_state_dict(load_generator_checkpoint(path), strict=True)
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    bare = tmp_path / "bare.pth"
    torch.save(src.state_dict(), bare)
    assert sorted(load_generator_checkpoint(bare)) == sorted(src.state_dict())

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_generator_checkpoint(tmp_path)


def test_nearest_resize_ops_match_jax(rng):
    from climsr_tpu.ops.resize import nearest_downsample as jax_down
    from climsr_tpu.ops.resize import nearest_upsample as jax_up
    from climsr_tpu_torch.ops.resize import nearest_downsample, nearest_upsample

    x = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    for factor in (1, 2, 3):
        _assert_close(nearest_upsample(_nchw(x), factor), jax_up(jnp.asarray(x), factor), rel=0)
        _assert_close(nearest_downsample(_nchw(x), factor), jax_down(jnp.asarray(x), factor), rel=0)
