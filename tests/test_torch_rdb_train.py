# -*- coding: utf-8 -*-
"""The port's RDB training path (kernels B1 and B2 and ``FusedRDB``) against the JAX package's.

On the CPU the wrappers run their plain versions (``rdb_fwd_save_reference``,
``rdb_bwd_reference``); they are held against the Pallas kernels
``_rdb_t_fwd_save_raw`` / ``_rdb_t_bwd_raw`` and ``jax.grad`` of
``fused_rdb_t`` / ``fused_rdb_res_t``, run in interpret mode, on the same
numpy inputs in f32 (nf=16, gc=8, 2 images of 8x16). Tolerance: 1e-4 of
max|ref| (summation order only). The CUDA kernels are compared with the plain
versions on the card (``chip_smoke.py`` and the ``cuda``-marked test below).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.ops.pallas.rdb import (
    _rdb_t_bwd_raw,
    _rdb_t_fwd_save_raw,
    cl_to_nhwc,
    fused_rdb_res_t,
    fused_rdb_t,
    nhwc_to_cl,
)
from climsr_tpu_torch.ops import head_bwd, rdb

torch.set_num_threads(1)

REL_TOL = 1e-4
N, H, W, NF, GC = 2, 8, 16, 16, 8
SCALES = [pytest.param(None, (0.2, 1.0), id="plain-0.2-1"), pytest.param("x0", (0.04, 0.2), id="x0-0.04-0.2")]


def _case(rng, n=N, h=H, w=W, nf=NF, gc=GC):
    """Numpy inputs: x, x0, g (N, H, W, nf) and HWIO weights/biases of the five convs."""
    x, x0, g = (rng.normal(size=(n, h, w, nf)).astype(np.float32) for _ in range(3))
    ws = []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        ws.append(rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1)
        ws.append(rng.normal(size=(cout,)).astype(np.float32) * 0.1)
    return x, x0, g, ws


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _torch_weights(ws, requires_grad=False):
    return [
        (torch.from_numpy(ws[2 * k].transpose(3, 2, 0, 1).copy()).requires_grad_(requires_grad),
         torch.from_numpy(ws[2 * k + 1].copy()).requires_grad_(requires_grad))
        for k in range(5)
    ]


def _close(got: torch.Tensor, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * np.abs(want).max())


def _close_nhwc(got_nchw: torch.Tensor, want_nhwc, rel=REL_TOL):
    _close(got_nchw.detach().permute(0, 2, 3, 1), want_nhwc, rel)


def _close_oihw(got: torch.Tensor, want_hwio):
    _close(got, np.asarray(want_hwio).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("res,scales", SCALES)
def test_fwd_save_reference_matches_pallas_fwd_save(rng, res, scales):
    x, x0, _, ws = _case(rng)
    x0t = nhwc_to_cl(jnp.asarray(x0)) if res else None
    out_t, feat_t = _rdb_t_fwd_save_raw(nhwc_to_cl(jnp.asarray(x)), H, W, *ws, 1, x0t=x0t)
    out, feat = rdb.rdb_fwd_save_reference(_nchw(x), _torch_weights(ws), _nchw(x0) if res else None)
    _close_nhwc(out, cl_to_nhwc(out_t, N, H, W))
    _close_nhwc(feat, cl_to_nhwc(feat_t, N, H, W))
    assert feat.shape == (N, NF + 4 * GC, H, W) and feat.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("res,scales", SCALES)
def test_bwd_reference_matches_pallas_bwd(rng, res, scales):
    """Both scale pairs, on the same saved features and upstream gradient."""
    x, _, g, ws = _case(rng)
    _, feat_t = _rdb_t_fwd_save_raw(nhwc_to_cl(jnp.asarray(x)), H, W, *ws, 1)
    want = _rdb_t_bwd_raw(feat_t, nhwc_to_cl(jnp.asarray(g)), tuple(jnp.asarray(a) for a in ws), H, W, 1, *scales)
    feat = _nchw(np.asarray(cl_to_nhwc(feat_t, N, H, W)))
    dx, dws, dbs = rdb.rdb_bwd_reference(feat, _nchw(g), _torch_weights(ws), *scales)
    _close_nhwc(dx, cl_to_nhwc(want[0], N, H, W))
    for k in range(5):
        _close_oihw(dws[k], want[1 + 2 * k])
        _close(dbs[k], want[2 + 2 * k])


def test_bwd_reference_matches_pallas_bwd_at_gc32(rng):
    """The reference defaults' widths (nf=64, gc=32), one image of 8 x 16, the
    enclosing-residual scales. (The Pallas backward needs gc <= nf: its
    gradient stack has max(9 gc, 9 nf) rows and conv5's product reads them all.)"""
    n, h, w, nf, gc = 1, 8, 16, 64, 32
    x, _, g, ws = _case(rng, n, h, w, nf, gc)
    _, feat_t = _rdb_t_fwd_save_raw(nhwc_to_cl(jnp.asarray(x)), h, w, *ws, 1)
    want = _rdb_t_bwd_raw(feat_t, nhwc_to_cl(jnp.asarray(g)), tuple(jnp.asarray(a) for a in ws), h, w, 1, 0.04, 0.2)
    feat = _nchw(np.asarray(cl_to_nhwc(feat_t, n, h, w)))
    dx, dws, dbs = rdb.rdb_bwd_reference(feat, _nchw(g), _torch_weights(ws), 0.04, 0.2)
    assert feat.shape == (n, nf + 4 * gc, h, w)
    _close_nhwc(dx, cl_to_nhwc(want[0], n, h, w))
    for k in range(5):
        _close_oihw(dws[k], want[1 + 2 * k])
        _close(dbs[k], want[2 + 2 * k])


@pytest.mark.parametrize("res,scales", SCALES)
def test_fused_rdb_gradients_match_jax_grad_of_the_pallas_rdb(rng, res, scales):
    """FusedRDB (B1 forward, B2 backward; their plain versions here) against
    jax.grad through the Pallas custom_vjp, for x, x0 and every weight and bias."""
    x, x0, g, ws = _case(rng)
    xt, x0t, gt = (nhwc_to_cl(jnp.asarray(a)) for a in (x, x0, g))

    if res:
        def jax_loss(xt, x0t, *wb):
            return jnp.sum(fused_rdb_res_t(xt, x0t, H, W, *wb, 1) * gt)

        want = jax.grad(jax_loss, argnums=tuple(range(12)))(xt, x0t, *ws)
    else:
        def jax_loss(xt, *wb):
            return jnp.sum(fused_rdb_t(xt, H, W, *wb, 1) * gt)

        want = jax.grad(jax_loss, argnums=tuple(range(11)))(xt, *ws)
        want = (want[0], None) + tuple(want[1:])

    tx = _nchw(x).requires_grad_(True)
    tx0 = _nchw(x0).requires_grad_(True) if res else None
    weights = _torch_weights(ws, requires_grad=True)
    out = rdb.fused_rdb(tx, weights, tx0)
    assert type(out.grad_fn).__name__ == "FusedRDBBackward"
    out.backward(_nchw(g))
    _close_nhwc(tx.grad, cl_to_nhwc(want[0], N, H, W))
    if res:
        _close_nhwc(tx0.grad, cl_to_nhwc(want[1], N, H, W))
    for k, (wt, bs) in enumerate(weights):
        _close_oihw(wt.grad, want[2 + 2 * k])
        _close(bs.grad, want[3 + 2 * k])


@pytest.mark.parametrize("res,scales", SCALES)
def test_backward_chain_of_kernel_b2_is_the_input_gradient(rng, res, scales):
    """Kernel B2's dX part runs the input gradient as a forward chain over
    [dz_5, dz_4, .., dz_1] with ``transposed_chain``'s weights (forward conv
    shapes). That algorithm, written out here with plain convs, gives
    rdb_bwd_reference's dx; its packing takes the forward's shapes."""
    x, _, g, ws = _case(rng)
    weights = _torch_weights(ws)
    tx, tg = _nchw(x), _nchw(g)
    _, feat = rdb.rdb_fwd_save_reference(tx, weights)
    chain = rdb.transposed_chain(weights)
    gy, gx = scales
    buf = tg * gy
    for s in range(4):
        a = torch.nn.functional.conv2d(buf, chain[s][0], padding=1)
        h = feat[:, NF + (3 - s) * GC:NF + (4 - s) * GC]
        buf = torch.cat([buf, a * torch.where(h > 0, 1.0, 0.2)], 1)
    dx = tg * gx + torch.nn.functional.conv2d(buf, chain[4][0], padding=1)
    want, _, _ = rdb.rdb_bwd_reference(feat, tg, weights, gy, gx)
    torch.testing.assert_close(dx, want, rtol=0, atol=REL_TOL * want.abs().max().item())
    packed = rdb.pack_rdb_weights(chain, torch.float32)
    assert (packed.nf, packed.gc) == (NF, GC)


def _assert_wgrad_jobs_cover_once(jobs, nf, gc):
    """Each job's slice (rows co0 .. co0 + 15 and inputs ci0 .. ci0 + cic - 1 of
    dW_j, every tap) hits each weight of [dW_1 .. dW_5] exactly once, and the
    growth jobs at ci0 = 0 each growth bias once; returns the weight count."""
    sizes = [cout * cin * 9 for cout, cin, _, _ in rdb._conv_shapes(nf, gc)]
    weights_hit = np.zeros(sum(sizes), np.int64)
    bias_hit = np.zeros(4 * gc, np.int64)
    for zc, j, co0, cin, woff, ci0, cic in jobs.tolist():
        assert cin == nf + j * gc and woff == sum(sizes[:j])
        assert 16 <= cic <= 128 and cic % 16 == 0 and ci0 % 16 == 0 and ci0 + cic <= cin
        # z = [dz_5, dz_4 .. dz_1]: channel zc belongs to the output gradient of conv j
        assert (zc < nf) == (j == 4) and zc == (co0 if j == 4 else nf + (3 - j) * gc + co0)
        dw = weights_hit[woff:woff + sum(sizes[j:j + 1])].reshape(-1, cin, 9)  # OIHW view of dW_j
        dw[co0:co0 + 16, ci0:ci0 + cic] += 1
        if j < 4 and ci0 == 0:
            bias_hit[j * gc + co0: j * gc + co0 + 16] += 1
    assert (weights_hit == 1).all() and (bias_hit == 1).all()  # the same for every split: the jobs do not vary
    return sum(sizes)


def test_wgrad_plan_covers_every_dw_entry_and_growth_bias_once_per_split():
    """Kernel B2's bf16 dW pass at the flagship widths (nf=64, gc=16) and the
    training shape's 33 splits: in every split the blocks' slices (rows co0 ..
    co0 + 15 of dW_j, all cin inputs and 9 taps: every cin <= 128, one job per
    16-channel group of z) cover each of the 124,416 weights exactly once, and
    the growth jobs each of the 64 growth biases."""
    nf, gc, splits = 64, 16, 33
    jobs, bounds = rdb.wgrad_plan(192, 32, 32, nf, gc, splits)
    assert jobs.dtype == bounds.dtype == torch.int32 and jobs.shape == (8, 7) and bounds.shape == (splits + 1,)
    assert (jobs[:, 5] == 0).all() and (jobs[:, 6] == jobs[:, 3]).all()
    assert _assert_wgrad_jobs_cover_once(jobs, nf, gc) == 124416
    b = bounds.tolist()
    assert b[0] == 0 and b[-1] == 192 * 4 * 2 and all(lo <= hi for lo, hi in zip(b, b[1:]))


def test_wgrad_plan_at_gc32_cuts_the_wide_convs_in_two_by_input_channels():
    """At the reference defaults (nf=64, gc=32) conv5's 192 inputs and conv4's
    160 exceed a job's 128 (the kernel's two 55,104-byte stages): each of
    their 16-output groups becomes two jobs of 96 or 80 inputs, 18 jobs for
    12 groups of z. The jobs still cover each of the 239,616 weights and 128
    growth biases exactly once."""
    nf, gc = 64, 32
    jobs, _ = rdb.wgrad_plan(192, 32, 32, nf, gc, 14)
    assert jobs.shape == (18, 7) and int(jobs[:, 6].max()) <= 128
    assert sorted(set(jobs[:, 6].tolist())) == [64, 80, 96, 128]
    assert _assert_wgrad_jobs_cover_once(jobs, nf, gc) == 239616


@pytest.mark.parametrize("n,h,w,splits", [(3, 29, 45, 33), (2, 8, 16, 5), (1, 7, 5, 3)],
                         ids=["ragged-3x29x45", "one-tile-each-2x8x16", "more-splits-than-tiles-1x7x5"])
def test_wgrad_plan_splits_cover_each_pixel_once(n, h, w, splits):
    """The splits' tiles, mapped to pixels as the kernel maps them (8 x 16
    tiles clipped at the image's edge), cover every pixel of every image
    exactly once; a split may be empty but never negative."""
    jobs, bounds = rdb.wgrad_plan(n, h, w, 64, 16, splits)
    ty, tx = -(-h // 8), -(-w // 16)
    hit = np.zeros((n, h, w), np.int64)
    b = bounds.tolist()
    for s in range(splits):
        assert b[s] <= b[s + 1]
        for t in range(b[s], b[s + 1]):
            img, y0, x0 = t // (ty * tx), 8 * ((t // tx) % ty), 16 * (t % tx)
            hit[img, y0:y0 + 8, x0:x0 + 16] += 1
    assert b[0] == 0 and b[-1] == n * ty * tx and (hit == 1).all()


def test_wrappers_on_cpu_count_no_launch(rng):
    x, _, g, ws = _case(rng)
    weights = _torch_weights(ws)
    for f in (rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd):
        f.launches = 0
    out, feat = rdb.fused_rdb_fwd_save(_nchw(x), weights)
    rdb.fused_rdb_bwd(feat, _nchw(g), weights, 0.2, 1.0)
    assert rdb.fused_rdb_fwd_save.launches == 0 and rdb.fused_rdb_bwd.launches == 0


# Every function of the port that launches a CUDA kernel (it counts
# ``.launches``) and the differentiable entry point that carries it in
# training. A kernel wrapper that returns a tensor without ``grad_fn`` on the
# card would cut the graph silently; here each entry point is called on the
# CPU with inputs that require grad, through the same autograd.Function that
# wraps both devices' branches.
def _rdb_entry(rng):
    x, x0, _, ws = _case(rng, n=1, h=4, w=5)
    return rdb.fused_rdb(_nchw(x).requires_grad_(True), _torch_weights(ws, True), _nchw(x0))


def _head_entry(rng):
    x = torch.from_numpy(rng.normal(size=(1, 3, 6, 7)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(64, 3, 9, 9)).astype(np.float32)).requires_grad_(True)
    return head_bwd.fusion_conv1(x, w, torch.zeros(64, requires_grad=True))


def _rdb_nhwc_entry(rng):
    x, _, _, ws = _case(rng, n=1, h=4, w=5)
    return rdb.fused_rdb_nhwc(torch.from_numpy(x).requires_grad_(True), *(torch.from_numpy(a) for a in ws))


def _hr_tail_entry(rng):
    from climsr_tpu_torch.ops import head

    x = torch.from_numpy(rng.normal(size=(1, 64, 5, 6)).astype(np.float32)).requires_grad_(True)
    return head.fused_hr_tail(x, torch.zeros(64, 64, 3, 3), torch.zeros(64), torch.zeros(1, 64, 3, 3), torch.zeros(1))


def _d_tail_bn_entry(rng):
    from climsr_tpu_torch.models.common import TorchBatchNorm
    from climsr_tpu_torch.ops import d_tail

    y = torch.from_numpy(rng.normal(size=(2, 8, 3, 4)).astype(np.float32)).requires_grad_(True)
    return d_tail.bias_leaky_bn_pad(y, torch.zeros(8, requires_grad=True), TorchBatchNorm(8))


def _d_tail_pad_entry(rng):
    from climsr_tpu_torch.ops import d_tail

    y = torch.from_numpy(rng.normal(size=(2, 8, 3, 4)).astype(np.float32)).requires_grad_(True)
    return d_tail.bias_leaky_pad(y, torch.zeros(8, requires_grad=True))


KERNEL_WRAPPERS = {
    "climsr_tpu_torch.ops.rdb.fused_rdb": _rdb_entry,
    "climsr_tpu_torch.ops.rdb.fused_rdb_fwd_save": _rdb_entry,
    "climsr_tpu_torch.ops.rdb.fused_rdb_bwd": _rdb_entry,
    "climsr_tpu_torch.ops.rdb.fused_rdb_nhwc": _rdb_nhwc_entry,
    "climsr_tpu_torch.ops.head.fused_hr_tail": _hr_tail_entry,
    "climsr_tpu_torch.ops.head_bwd.conv9_dx_c0": _head_entry,
    "climsr_tpu_torch.ops.d_tail.bias_leaky_bn_pad": _d_tail_bn_entry,
    "climsr_tpu_torch.ops.d_tail.bias_leaky_pad": _d_tail_pad_entry,
}


def _dc0_with_grad(rng):
    g = torch.from_numpy(rng.normal(size=(1, 16, 5, 6)).astype(np.float32)).requires_grad_(True)
    return head_bwd.dc0(g, torch.zeros(9, 9, 16))


# Wrappers that take no gradient: they refuse an input that needs one rather
# than return a result without ``grad_fn``.
FORWARD_ONLY_WRAPPERS = {
    "climsr_tpu_torch.ops.head_bwd.dc0": _dc0_with_grad,
}


def test_every_kernel_wrapper_keeps_the_autograd_graph(rng):
    import importlib
    import pkgutil

    import climsr_tpu_torch.ops as ops

    found = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"climsr_tpu_torch.ops.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches") and getattr(obj, "__module__", None) == mod.__name__:
                found.add(f"{mod.__name__}.{name}")
    assert found == set(KERNEL_WRAPPERS) | set(FORWARD_ONLY_WRAPPERS), \
        "a new kernel wrapper needs its differentiable entry point here"
    for name, entry in KERNEL_WRAPPERS.items():
        out = entry(rng)
        assert out.grad_fn is not None and out.requires_grad, name
        out.sum().backward()
    for name, entry in FORWARD_ONLY_WRAPPERS.items():
        with pytest.raises(ValueError, match="gradient"):
            entry(rng)


def test_fused_rdb_without_grad_runs_the_forward_only(rng):
    x, _, _, ws = _case(rng, n=1, h=4, w=5)
    weights = _torch_weights(ws, requires_grad=True)
    with torch.no_grad():
        assert rdb.fused_rdb(_nchw(x), weights).grad_fn is None
    assert rdb.fused_rdb(_nchw(x), _torch_weights(ws)).grad_fn is None


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 have no CPU mode (chip_smoke.py covers them)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gc", [16, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_cuda_kernels_b1_b2_match_plain_versions(rng, cuda_device, dtype, tol, gc):
    """A ragged image with tiles across every border, both scale pairs, at
    the flagship and the reference-default growth widths; tolerances as in chip_smoke.py."""
    x, x0, g, ws = _case(rng, 2, 29, 45, 64, gc)
    tx, tx0, tg = (_nchw(a).to(cuda_device, dtype).contiguous(memory_format=torch.channels_last) for a in (x, x0, g))
    weights = [(a.to(cuda_device, dtype), b.to(cuda_device, dtype)) for a, b in _torch_weights(ws)]
    for res, (gy, gx) in ((None, (0.2, 1.0)), (tx0, (0.04, 0.2))):
        out, feat = rdb.fused_rdb_fwd_save(tx, weights, res)
        ref_out, ref_feat = rdb.rdb_fwd_save_reference(tx, weights, res)
        got = [out, feat, *(t for part in rdb.fused_rdb_bwd(feat, tg, weights, gy, gx)[1:] for t in part)]
        want = [ref_out, ref_feat, *(t for part in rdb.rdb_bwd_reference(feat, tg, weights, gy, gx)[1:] for t in part)]
        for a, b in zip(got, want):
            assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()
