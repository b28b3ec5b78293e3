# -*- coding: utf-8 -*-
"""The fusion head's input gradient to channel 0 (kernel C) against the JAX package's.

On the CPU ``conv9_dx_c0`` runs its plain version; it and ``fusion_conv1`` are
held against the JAX ``conv9_dx_c0`` (the Pallas kernel in interpret mode)
and ``fusion_conv1`` on the same numpy inputs in f32, 2 images of 32x64 (a
shape the JAX kernel takes). Tolerance: 1e-4 of max|ref| (summation order).
Then the gate: the port uses kernel C only for a one-channel ESRGAN, and its
gradients at ``out_channels=3`` are exact where the JAX ``use_pallas=True``
model's are not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.ops.pallas.head_bwd import conv9_dx_c0 as jax_conv9_dx_c0
from climsr_tpu.ops.pallas.head_bwd import fusion_conv1 as jax_fusion_conv1
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.ops import head_bwd

torch.set_num_threads(1)

REL_TOL = 1e-4


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.array(k).transpose(3, 2, 0, 1).copy())


def _close(got: torch.Tensor, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * np.abs(want).max())


def _close_nhwc(got_nchw: torch.Tensor, want_nhwc, rel=REL_TOL):
    _close(got_nchw.detach().permute(0, 2, 3, 1), want_nhwc, rel)


def _case(rng, n=2, h=32, w=64, cin=3, cout=64):
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    g = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    kernel = (rng.normal(size=(9, 9, cin, cout)) / np.sqrt(81 * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32) * 0.1
    return x, g, kernel, bias


def test_conv9_dx_c0_reference_matches_the_pallas_kernel(rng):
    _, g, kernel, _ = _case(rng)
    want = jax_conv9_dx_c0(jnp.asarray(g), jnp.asarray(kernel))
    got = head_bwd.conv9_dx_c0(_nchw(g), _oihw(kernel))
    assert got.shape == (2, 1, 32, 64)
    _close_nhwc(got, want)


def test_fusion_conv1_matches_jax_forward_and_vjp(rng):
    """Forward, dW, db and dX (exact for channel 0, zero for channels 1+), as the JAX custom_vjp."""
    x, g, kernel, bias = _case(rng)
    out, vjp = jax.vjp(jax_fusion_conv1, jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    dx, dk, db = vjp(jnp.asarray(g))
    tx = _nchw(x).requires_grad_(True)
    tw = _oihw(kernel).requires_grad_(True)
    tb = torch.from_numpy(bias.copy()).requires_grad_(True)
    got = head_bwd.fusion_conv1(tx, tw, tb)
    _close_nhwc(got, out)
    got.backward(_nchw(g))
    _close_nhwc(tx.grad, dx)
    assert tx.grad[:, 1:].abs().max() == 0
    _close(tw.grad, np.asarray(dk).transpose(3, 2, 0, 1))
    _close(tb.grad, db)


def test_wrapper_counts_no_launch_on_cpu_and_refuses_other_devices(rng):
    _, g, kernel, _ = _case(rng, n=1, h=5, w=6)
    head_bwd.conv9_dx_c0.launches = 0
    head_bwd.conv9_dx_c0(_nchw(g), _oihw(kernel))
    assert head_bwd.conv9_dx_c0.launches == 0
    with pytest.raises(ValueError):
        head_bwd.conv9_dx_c0(_nchw(g).to("meta"), _oihw(kernel).to("meta"))


def _esrgan_grads(rng, out_channels):
    """Parameter gradients of the same ESRGAN (nf=16, nb=1, gc=8, 8x16 LR) in
    the port and in the JAX package with use_pallas False and True."""
    x = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    e = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    m = (rng.random((2, 32, 64, 1)) > 0.3).astype(np.float32)
    hr = rng.normal(size=(2, 32, 64, out_channels)).astype(np.float32)
    grads = {}
    for use_pallas in (False, True):
        mod = jax_create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=out_channels, use_pallas=use_pallas)
        params = mod.init(jax.random.PRNGKey(0), x, e, m)["params"]

        def loss(p):
            return jnp.mean(jnp.abs(mod.apply({"params": p}, x, e, m) - hr))

        grads[use_pallas] = state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    port = create_generator("esrgan", device="cpu", train=True, nf=16, nb=1, gc=8, out_channels=out_channels)
    port.load_state_dict(state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    sr = port(_nchw(x), _nchw(e), _nchw(m))
    torch.mean(torch.abs(sr - _nchw(hr))).backward()
    return {k: p.grad for k, p in port.named_parameters()}, grads[False], grads[True], port


def test_three_channel_esrgan_gradients_are_exact_where_the_jax_pallas_model_is_not(rng):
    got, exact, jax_pallas, port = _esrgan_grads(rng, out_channels=3)
    assert not port.srcnn.fusion_dx_c0
    for k, want in exact.items():
        _close(got[k], want.numpy())
    # the JAX use_pallas model zeroes the cotangent of fusion channels 1-2
    # (generator outputs here), so every parameter before the head is off
    want, bad = exact["conv_last.weight"].numpy(), jax_pallas["conv_last.weight"].numpy()
    assert np.abs(bad - want).max() > 0.1 * np.abs(want).max()


def test_one_channel_esrgan_routes_the_head_through_kernel_c(rng):
    got, exact, jax_pallas, port = _esrgan_grads(rng, out_channels=1)
    assert port.srcnn.fusion_dx_c0
    for k, want in jax_pallas.items():
        _close(got[k], want.numpy())
        _close(got[k], exact[k].numpy())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel C has no CPU mode (chip_smoke.py covers it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_cuda_kernel_c_matches_plain_version(rng, cuda_device, dtype, tol):
    _, g, kernel, _ = _case(rng, n=2, h=45, w=91)
    tg = _nchw(g).to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    tw = _oihw(kernel).to(cuda_device, dtype)
    before = head_bwd.conv9_dx_c0.launches
    got = head_bwd.conv9_dx_c0(tg, tw).float()
    ref = head_bwd.conv9_dx_c0_reference(tg, tw).float()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert head_bwd.conv9_dx_c0.launches == before + 1
