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


def _c_plan(g, weight, blocks):
    """Kernel C's bf16 plan in numpy (f32), with its work split: the
    (image, strip, output row) sequence cut into ``blocks`` equal shares,
    each walked down in segments of one (image, strip); strips of T output
    columns, at most 128 wide. For each output row, P = A @ B^T with A the
    row's source columns x (dy, c) (g zero outside) and B = ``wrev_matrix``,
    then out[j] = sum_dx P[j + dx][dx]. Returns (out, how often each output
    was written)."""
    n, h, w, c = g.shape
    b = head_bwd.wrev_matrix(torch.from_numpy(weight)).numpy()  # (16, 9c): [dx][dy * c + ci]
    strips = -(-w // 128)
    t = -(-w // strips)
    total = n * strips * h
    out, hits = np.zeros((n, h, w), np.float32), np.zeros((n, h, w), np.int64)
    for blk in range(blocks):
        f, end = total * blk // blocks, total * (blk + 1) // blocks
        while f < end:
            seg, y0 = divmod(f, h)
            length = min(h - y0, end - f)
            f += length
            img, st = divmod(seg, strips)
            x0 = st * t
            tw = min(t, w - x0)
            cols = np.arange(x0 - 4, x0 + tw + 4)  # the npix = tw + 8 source columns
            for y in range(y0, y0 + length):
                a = np.zeros((len(cols), 9, c), np.float32)
                for dy in range(9):
                    r = y + dy - 4
                    ok = (cols >= 0) & (cols < w)
                    if 0 <= r < h:
                        a[ok, dy] = g[img, r, cols[ok]]
                p = a.reshape(len(cols), 9 * c) @ b.T  # (npix, 16), columns 9..15 zero
                assert not p[:, 9:].any()
                for j in range(tw):
                    out[img, y, x0 + j] = sum(p[j + dx, dx] for dx in range(9))
                    hits[img, y, x0 + j] += 1
    return out, hits


@pytest.mark.parametrize("n,h,w,blocks", [(2, 5, 133, 7), (3, 4, 21, 5)])
def test_c_plan_row_gemm_and_antidiagonal_sums_give_the_reference(rng, n, h, w, blocks):
    """On ragged shapes (two strips of 67 columns at W = 133; shares that
    start inside an image), every output is written once and the plan gives
    conv9_dx_c0_reference, to 1e-4 of max|ref| (f32, summation order)."""
    _, g, kernel, _ = _case(rng, n=n, h=h, w=w)
    got, hits = _c_plan(g, _oihw(kernel).numpy(), blocks)
    assert (hits == 1).all()
    want = head_bwd.conv9_dx_c0_reference(_nchw(g), _oihw(kernel))[:, 0]
    _close(torch.from_numpy(got), want.numpy())


def test_c_plan_gives_the_pallas_kernel(rng):
    """The same plan against the JAX conv9_dx_c0 (interpret mode) at 2 x 32 x 64, 1e-4 of max|ref|."""
    _, g, kernel, _ = _case(rng)
    want = np.asarray(jax_conv9_dx_c0(jnp.asarray(g), jnp.asarray(kernel)))[..., 0]
    got, _ = _c_plan(g, _oihw(kernel).numpy(), blocks=3)
    _close(torch.from_numpy(got), want)


def test_c_packed_wrev_is_the_mma_b_fragment_order(rng):
    """pack_wrev is B = Wrev (B[k][n] = W[c, 0, 8 - dy, 8 - n] at k = 64 dy +
    c, zero for n >= 9) rounded to bf16 in mma.m16n8k16's B-fragment order
    (PTX ISA, m16n8k16 fragments): lane l (g = l // 4, t = l % 4) of k-step s
    holds, low half first, {B[16s + 2t][g], B[16s + 2t + 1][g]} (word 0),
    {B[16s + 2t + 8][g], B[16s + 2t + 9][g]} (word 1), and words 2, 3 the
    same for n = 8 + g: one 16-byte vector per lane and k-step."""
    weight = torch.from_numpy(rng.normal(size=(64, 3, 9, 9)).astype(np.float32))
    packed = head_bwd.pack_wrev(weight)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 36 * 32 * 8
    got = packed.float().numpy().reshape(36, 32, 4, 2)
    wb = weight.to(torch.bfloat16).float().numpy()

    def b_elem(k, n):
        dy, c = divmod(k, 64)
        return wb[c, 0, 8 - dy, 8 - n] if n < 9 else 0.0

    for s in range(36):
        for lane in range(32):
            g_, t = divmod(lane, 4)
            for word in range(4):
                for half in range(2):
                    n = g_ + 8 * (word // 2)
                    k = 16 * s + 2 * t + 8 * (word % 2) + half
                    assert got[s, lane, word, half] == b_elem(k, n)


def test_c_shared_memory_fits_one_block():
    """Kernel C's bf16 budget (csrc/conv9_dx_c0.cu kSmemB): a ring of 12 row
    slots (10 rows a step reads + 2 landing) of 136 pixels x 64 channels x 2
    bytes, and two steps' P strips of 2 rows x 136 columns x 9 f32."""
    ring = (8 + 2 + 2) * (128 + 8) * 64 * 2
    strips = 2 * 2 * (128 + 8) * 9 * 4
    assert ring + strips == 228480 <= 232448
    assert -(-(128 + 8) // 16) * 32 == 288  # one 16-column M-tile per warp: 9 warps


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
