# -*- coding: utf-8 -*-
"""Kernels E (the fused HR tail) and F (the probe's dc0) against the JAX package's.

On the CPU the wrappers run their plain versions; they are held, on the same
numpy inputs in f32, against the Pallas kernels run in interpret mode:

- E: ``fused_hr_tail`` (``climsr_tpu/ops/pallas/head.py``) at 2 images of
  16 x 24 in the transposed layout (transposed on the numpy side), the output
  and dX through the custom VJP;
- F: both variants of ``dc0_pallas`` (``scripts/bench_head_bwd_probe.py``,
  imported by path) at C=8 on one 128 x 128 image (the size the probe's
  module globals fix), and the port's ``conv9_dx_c0_reference`` on a ragged
  shape.

On the card F launches kernel C: its weight view through C's plain version
is checked here to give F's plain version. The CUDA kernels themselves are
compared with their plain versions on the card (``chip_smoke.py`` and the
``cuda``-marked tests below).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.ops.pallas.head import fused_hr_tail as jax_fused_hr_tail
from climsr_tpu.ops.pallas.head import hr_tail_reference as jax_hr_tail_reference
from climsr_tpu_torch.ops import head, head_bwd

torch.set_num_threads(1)

REL_TOL = 1e-4  # of max|ref|: f32, summation order only
ROOT = Path(__file__).resolve().parents[1]


def _probe_module():
    spec = importlib.util.spec_from_file_location("jax_bench_head_bwd_probe", ROOT / "scripts" / "bench_head_bwd_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _tail_case(rng, n=2, h=16, w=24):
    x = rng.normal(size=(n, h, w, 64)).astype(np.float32)
    whr = rng.normal(size=(3, 3, 64, 64)).astype(np.float32) * 0.1
    bhr = rng.normal(size=(64,)).astype(np.float32) * 0.1
    wcl = rng.normal(size=(3, 3, 64, 1)).astype(np.float32) * 0.1
    bcl = rng.normal(size=(1,)).astype(np.float32) * 0.1
    return x, (whr, bhr, wcl, bcl)


def _oihw_weights(weights):
    whr, bhr, wcl, bcl = weights
    return [torch.from_numpy(whr.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bhr.copy()),
            torch.from_numpy(wcl.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bcl.copy())]


def test_hr_tail_matches_the_pallas_kernel_and_its_vjp(rng):
    """Output and dX of sum(out ** 2), as tests/test_pallas.py takes them."""
    n, h, w = 2, 16, 24
    x, weights = _tail_case(rng, n, h, w)
    jw = [jnp.asarray(a) for a in weights]
    xt = jnp.transpose(jnp.asarray(x), (3, 0, 1, 2)).reshape(64, n * h * w)
    want = np.asarray(jax_fused_hr_tail(xt, h, w, *jw, 1)).reshape(n, h, w)
    want_dx = jax.grad(lambda xt: jnp.sum(jax_fused_hr_tail(xt, h, w, *jw, 1) ** 2))(xt)
    want_dx = np.asarray(want_dx).reshape(64, n, h, w).transpose(1, 0, 2, 3)

    tx = _nchw(x).requires_grad_(True)
    tw = _oihw_weights(weights)
    head.fused_hr_tail.launches = 0
    out = head.fused_hr_tail(tx, *tw)
    assert out.shape == (n, 1, h, w) and out.grad_fn is not None
    _close(out.detach()[:, 0], want)
    (out ** 2).sum().backward()
    _close(tx.grad, want_dx)
    assert head.fused_hr_tail.launches == 0
    _close(head.hr_tail_reference(tx.detach(), tw).permute(0, 2, 3, 1),
           jax_hr_tail_reference(jnp.asarray(x), tuple(jw)))


def test_hr_tail_parameter_gradients_match_the_jax_vjp(rng):
    """dW and db of all four parameters through FusedHRTail's backward (autograd
    of the plain version) against JAX's VJP of its reference, to 1e-4 of max."""
    n, h, w = 1, 7, 9  # ragged: the port takes any H, W
    x, weights = _tail_case(rng, n, h, w)
    jw = [jnp.asarray(a) for a in weights]
    g = jax.grad(lambda *p: jnp.sum(jax_hr_tail_reference(jnp.asarray(x), p) ** 2), argnums=(0, 1, 2, 3))(*jw)
    tw = [t.requires_grad_(True) for t in _oihw_weights(weights)]
    (head.fused_hr_tail(_nchw(x), *tw) ** 2).sum().backward()
    for got, want in zip(tw, g):
        want = np.asarray(want)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        _close(got.grad, want)


def _lrelu(v):
    return np.where(v > 0, v, np.float32(0.2) * v)


@pytest.mark.parametrize("n,h,w", [(1, 13, 19), (2, 12, 16)])
def test_e_tiles_projection_and_shift_adds_give_the_reference(rng, n, h, w):
    """Kernel E's bf16 plan in numpy (f32): 12 x 16 output tiles; per tile,
    lrelu(x) staged with a 2-pixel halo (16 x 20, zero outside), HRconv over
    the 14 x 18 region as nine tap-shifted products, bias, lrelu, zero outside
    the image; conv_last as a projection of the region onto its 9 taps, then
    out = sum over the taps of proj[pixel + tap][tap] + bias. Every output is
    written once and the plan gives hr_tail_reference, to 1e-4 of max|ref|."""
    x, (whr, bhr, wcl, bcl) = _tail_case(rng, n, h, w)
    th, tw = 12, 16
    out, hits = np.zeros((n, h, w), np.float32), np.zeros((n, h, w), np.int64)
    a = _lrelu(x)
    taps = wcl[..., 0].reshape(9, 64)  # [3 ky + kx][c]
    for img in range(n):
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                stage = np.zeros((th + 4, tw + 4, 64), np.float32)
                ys, xs = np.arange(ty0 - 2, ty0 + th + 2), np.arange(tx0 - 2, tx0 + tw + 2)
                iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
                stage[np.ix_(iy, ix)] = a[img][np.ix_(ys[iy], xs[ix])]
                hid = np.zeros((th + 2, tw + 2, 64), np.float32)
                for ky in range(3):
                    for kx in range(3):
                        hid += stage[ky:ky + th + 2, kx:kx + tw + 2] @ whr[ky, kx]
                ry, rx = np.arange(ty0 - 1, ty0 + th + 1), np.arange(tx0 - 1, tx0 + tw + 1)
                inside = ((ry >= 0) & (ry < h))[:, None] & ((rx >= 0) & (rx < w))[None, :]
                hid = np.where(inside[..., None], _lrelu(hid + bhr), 0)
                proj = hid @ taps.T  # (14, 18, 9)
                o = sum(proj[t // 3:t // 3 + th, t % 3:t % 3 + tw, t] for t in range(9)) + bcl[0]
                oh, ow = min(th, h - ty0), min(tw, w - tx0)
                out[img, ty0:ty0 + oh, tx0:tx0 + ow] = o[:oh, :ow]
                hits[img, ty0:ty0 + oh, tx0:tx0 + ow] += 1
    assert (hits == 1).all()
    want = head.hr_tail_reference(_nchw(x), _oihw_weights((whr, bhr, wcl, bcl)))[:, 0]
    _close(out, want.numpy())


def test_e_packed_hrconv_is_wgmma_k_major_core_matrices(rng):
    """pack_hrconv is HRconv's weights rounded to bf16 in the RDB chain's
    last-conv order: k-step (16 input channels gl, tap), gl outermost, each
    wgmma's K-major B tile of 16 k x 64 outputs without swizzle (PTX ISA,
    wgmma shared-memory layouts): core matrix (output block b, k half kh) is
    8 rows (outputs 8b + r) of 8 k (16 bytes), at (2b + kh) * 128 bytes, as
    the kernel's descriptor says (128 bytes along K, 256 along N)."""
    whr = torch.from_numpy(rng.normal(size=(64, 64, 3, 3)).astype(np.float32))
    got = head.pack_hrconv(whr).float().numpy().reshape(4, 9, 8, 2, 8, 8)
    wb = whr.to(torch.bfloat16).float().numpy()
    for gl in range(4):
        for tap in range(9):
            for b in range(8):
                for kh in range(2):
                    for r in range(8):
                        np.testing.assert_array_equal(
                            got[gl, tap, b, kh, r], wb[8 * b + r, 16 * gl + 8 * kh:16 * gl + 8 * kh + 8, tap // 3, tap % 3])


def test_e_packed_conv_last_is_the_mma_b_fragment_order(rng):
    """pack_conv_last is B[k][n] = Wcl[0, k, n // 3, n % 3] (k = input
    channel, n = tap, zero for n >= 9) rounded to bf16 in mma.m16n8k16's
    B-fragment order (PTX ISA): lane l (g = l // 4, t = l % 4) of k-step s
    holds {B[16s + 2t][g], B[16s + 2t + 1][g]}, {B[16s + 2t + 8][g],
    B[16s + 2t + 9][g]}, then the same for n = 8 + g."""
    wcl = torch.from_numpy(rng.normal(size=(1, 64, 3, 3)).astype(np.float32))
    got = head.pack_conv_last(wcl).float().numpy().reshape(4, 32, 4, 2)
    wb = wcl.to(torch.bfloat16).float().numpy()[0]
    for s in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for word in range(4):
                for half in range(2):
                    n, k = g + 8 * (word // 2), 16 * s + 2 * t + 8 * (word % 2) + half
                    assert got[s, lane, word, half] == (wb[k, n // 3, n % 3] if n < 9 else 0.0)


def test_e_shared_memory_fits_one_block():
    """Kernel E's bf16 budget (csrc/hr_tail.cu kSmemBf16) at 12 x 16 output
    tiles: HRconv's weights, and for each of the two warpgroups an x stage of
    16 x 20 pixels x 72 channels and the 14 x 18-pixel intermediate at 64
    channels (bf16), over which conv_last's projection (14 x 18 x 9 f32)
    goes; the region is four 64-row M-blocks."""
    weights = 9 * 64 * 64 * 2
    stage = (12 + 4) * (16 + 4) * (64 + 8) * 2
    hidden = (12 + 2) * (16 + 2) * 64 * 2
    assert (12 + 2) * (16 + 2) * 9 * 4 <= hidden
    assert weights + 2 * (stage + hidden) == 230400 <= 232448
    assert (12 + 2) * (16 + 2) <= 4 * 64


def test_hr_tail_wrapper_refuses_other_devices(rng):
    x, weights = _tail_case(rng, 1, 4, 4)
    with pytest.raises(ValueError):
        head.fused_hr_tail(_nchw(x).to("meta"), *(t.to("meta") for t in _oihw_weights(weights)))


def test_dc0_variants_match_the_pallas_probe_kernels(rng):
    """Both variants against the TPU probe's kernels (interpret mode), C=8 on
    one 128 x 128 image, 1e-4 of max|ref| (f32)."""
    probe = _probe_module()
    c = 8
    g = rng.normal(size=(1, probe.H, probe.W, c)).astype(np.float32)
    w1c0 = rng.normal(size=(9, 9, c)).astype(np.float32) * 0.05
    g_t = jnp.transpose(jnp.asarray(g), (3, 0, 1, 2)).reshape(c, probe.H * probe.W)
    tg, tw = _nchw(g), torch.from_numpy(w1c0)
    head_bwd.dc0.launches = 0
    for variant in ("flat", "dyfac"):
        want = np.asarray(probe.dc0_pallas(g_t, jnp.asarray(w1c0), variant)).reshape(1, probe.H, probe.W)
        got = head_bwd.dc0(tg, tw, variant)
        assert got.shape == (1, 1, probe.H, probe.W)
        _close(got[:, 0], want)
    _close(head_bwd.dc0_reference(tg, tw).permute(0, 2, 3, 1), probe.dc0_reference(jnp.asarray(g), jnp.asarray(w1c0)))
    assert head_bwd.dc0.launches == 0


def test_dc0_is_kernel_c_function_on_a_ragged_shape(rng):
    """dc0(g, w1c0) == conv9_dx_c0_reference(g, W) with W[c, 0] = w1c0[..., c]."""
    g = rng.normal(size=(2, 13, 21, 16)).astype(np.float32)
    w1c0 = rng.normal(size=(9, 9, 16)).astype(np.float32) * 0.05
    tw = torch.from_numpy(w1c0)
    want = head_bwd.conv9_dx_c0_reference(_nchw(g), tw.permute(2, 0, 1).unsqueeze(1))
    for variant in ("flat", "dyfac"):
        _close(head_bwd.dc0(_nchw(g), tw, variant), want.numpy())
    with pytest.raises(ValueError):
        head_bwd.dc0(_nchw(g), tw, "rolled")
    with pytest.raises(ValueError, match="forward-only"):
        head_bwd.dc0(_nchw(g).requires_grad_(True), tw)
    with pytest.raises(ValueError):
        head_bwd.dc0(_nchw(g).to("meta"), tw.to("meta"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)], ids=["f32", "bf16"])
def test_dc0_weight_through_kernel_c_reference_is_dc0_reference(rng, dtype, tol):
    """On the card dc0 launches kernel C with ``dc0_weight(w1c0, g.dtype)``
    (W[c, 0] = w1c0[..., c], rounded to g's dtype): through C's plain version
    that view gives dc0_reference. Both sum the same products in f32 (a
    transposed conv against a flipped conv, so in another order) and round
    once to g's dtype: 1e-5 of max in f32, one bf16 step (2^-8) of max in
    bf16. C = 64, the probe's width."""
    g = torch.from_numpy(rng.normal(size=(2, 64, 13, 21)).astype(np.float32)).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    w1c0 = torch.from_numpy(rng.normal(size=(9, 9, 64)).astype(np.float32) * 0.05)
    weight = head_bwd.dc0_weight(w1c0, dtype)
    assert weight.shape == (64, 1, 9, 9) and weight.dtype == dtype
    assert torch.equal(weight[:, 0].float(), w1c0.to(dtype).float().permute(2, 0, 1))
    want = head_bwd.dc0_reference(g, w1c0)
    got = head_bwd.conv9_dx_c0_reference(g, weight)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (2, 1, 13, 21)
    _close(got.float().numpy(), want.float().numpy(), rel=tol)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels E and F have no CPU mode (chip_smoke.py covers them)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernels_e_and_f_match_plain_versions(rng, cuda_device, dtype, tol):
    """A ragged image with tiles across every border; tolerances as in chip_smoke.py."""
    x, weights = _tail_case(rng, 2, 45, 91)
    tx = _nchw(x).to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    tw = [t.to(cuda_device) for t in _oihw_weights(weights)]
    got, ref = head.fused_hr_tail(tx, *tw).float(), head.hr_tail_reference(tx, tw).float()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    w1c0 = torch.from_numpy(rng.normal(size=(9, 9, 64)).astype(np.float32) * 0.05).to(cuda_device)
    ref = head_bwd.dc0_reference(tx, w1c0).float()
    before = head_bwd.dc0.launches, head_bwd.conv9_dx_c0.launches
    for variant in ("flat", "dyfac"):
        got = head_bwd.dc0(tx, w1c0, variant).float()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    # F launches kernel C, counted as F's
    assert (head_bwd.dc0.launches, head_bwd.conv9_dx_c0.launches) == (before[0] + 2, before[1])
