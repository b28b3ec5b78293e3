# -*- coding: utf-8 -*-
"""ESRGAN's upsampling head in the phase form, against the JAX package, on the CPU in f32.

- ``nearest_up2_conv3`` (four 2x2 convs on the LR grid, interleaved) against
  the JAX ``nearest_up2_conv3`` and against the port's interpolate-then-conv
  form, forward and the gradient to the 3x3 weight and bias, atol 1e-5;
- one ESRGAN with ``fused_upsample=False`` against ``True``: the same
  parameters give the same output, and the ``state_dict`` keys are unchanged.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.ops.fused_upsample_conv import nearest_up2_conv3 as jax_nearest_up2_conv3
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.ops.fused_upsample_conv import nearest_up2_conv3, nearest_up2_conv3_plain

torch.set_num_threads(1)

ATOL = 1e-5


def _case(rng, n=2, h=6, w=7, c=8, f=5):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, c, f)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    # the cotangent of a mean-reduced loss
    probe = (rng.normal(size=(n, 2 * h, 2 * w, f)) / (n * 4 * h * w * f)).astype(np.float32)
    return x, kernel, bias, probe


def _torch_leaves(x, kernel, bias):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    return xt, wt, bt


@pytest.mark.parametrize("fn", [nearest_up2_conv3, nearest_up2_conv3_plain], ids=["phase", "plain"])
def test_forward_and_weight_gradient_match_the_jax_phase_form(rng, fn):
    x, kernel, bias, probe = _case(rng)

    def jax_loss(k, b):
        return jnp.sum(jax_nearest_up2_conv3(jnp.asarray(x), k, b) * probe)

    want = np.asarray(jax_nearest_up2_conv3(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    gk, gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(kernel), jnp.asarray(bias))

    xt, wt, bt = _torch_leaves(x, kernel, bias)
    out = fn(xt, wt, bt)
    assert out.shape == (2, 5, 12, 14)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want, atol=ATOL)
    (out * torch.from_numpy(probe).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gk).transpose(3, 2, 0, 1), atol=ATOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), atol=ATOL)


def test_phase_form_matches_the_plain_form_with_input_gradient(rng):
    x, kernel, bias, probe = _case(rng, n=1, h=5, w=9, c=4, f=3)
    grads = []
    outs = []
    for fn in (nearest_up2_conv3, nearest_up2_conv3_plain):
        xt, wt, bt = _torch_leaves(x, kernel, bias)
        xt.requires_grad_(True)
        out = fn(xt, wt, bt)
        (out * torch.from_numpy(probe).permute(0, 3, 1, 2)).sum().backward()
        outs.append(out.detach())
        grads.append((xt.grad, wt.grad, bt.grad))
    torch.testing.assert_close(outs[0], outs[1], atol=ATOL, rtol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_phase_form_builds_no_nearest_x2_tensor(rng, monkeypatch):
    """``fused_upsample=True`` never calls the interpolate."""
    import torch.nn.functional as F

    def refuse(*args, **kwargs):
        raise AssertionError("the phase form must not upsample")

    x, kernel, bias, _ = _case(rng)
    xt, wt, bt = _torch_leaves(x, kernel, bias)
    monkeypatch.setattr(F, "interpolate", refuse)
    assert nearest_up2_conv3(xt, wt, bt).shape == (2, 5, 12, 14)
    model = create_generator("esrgan", device="cpu", nf=8, nb=1, gc=8, out_channels=1, fused_upsample=True,
                             generator=torch.Generator().manual_seed(0))
    lr = torch.from_numpy(rng.normal(size=(1, 3, 4, 4)).astype(np.float32))
    hr = torch.zeros(1, 1, 16, 16)
    with torch.no_grad():
        assert model(lr, hr, hr).shape == (1, 1, 16, 16)


def test_esrgan_fused_upsample_flag_changes_no_number_nor_key(rng):
    kw = dict(device="cpu", nf=8, nb=1, gc=8, out_channels=1)
    fused = create_generator("esrgan", fused_upsample=True, generator=torch.Generator().manual_seed(3), **kw)
    plain = create_generator("esrgan", fused_upsample=False, **kw)
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert "upconv1.weight" in fused.state_dict() and "upconv2.weight" in fused.state_dict()
    plain.load_state_dict(fused.state_dict(), strict=True)
    lr = torch.from_numpy(rng.normal(size=(2, 3, 6, 5)).astype(np.float32))
    elev = torch.from_numpy(rng.normal(size=(2, 1, 24, 20)).astype(np.float32))
    mask = torch.ones(2, 1, 24, 20)
    with torch.no_grad():
        torch.testing.assert_close(fused(lr, elev, mask), plain(lr, elev, mask), atol=ATOL, rtol=0)
