# -*- coding: utf-8 -*-
"""The port's fused RDB (climsr_tpu_torch.ops.rdb) against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against the
JAX ``rdb_reference`` and the Pallas kernels ``fused_rdb_t`` /
``fused_rdb_res_t`` run in interpret mode, on the same numpy inputs, in f32.
Kernel D's entry point ``fused_rdb_nhwc`` is held against the JAX public
``fused_rdb`` (TPU kernel D in interpret mode) and its reference VJP.
Tolerance: 1e-4 of max|ref| (summation order only). The CUDA kernel itself is
compared with the plain version on the card (``chip_smoke.py`` and the
``cuda``-marked test below).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from climsr_tpu.ops.pallas.rdb import cl_to_nhwc, fused_rdb_res_t, fused_rdb_t, nhwc_to_cl
from climsr_tpu.ops.pallas.rdb import fused_rdb as jax_fused_rdb
from climsr_tpu.ops.pallas.rdb import rdb_reference as jax_rdb_reference
from climsr_tpu_torch.ops import rdb

torch.set_num_threads(1)

REL_TOL = 1e-4


def _case(rng, n, h, w, nf, gc):
    """Numpy inputs: x, x0 (N, H, W, nf) and HWIO weights/biases of the five convs."""
    x = rng.normal(size=(n, h, w, nf)).astype(np.float32)
    x0 = rng.normal(size=(n, h, w, nf)).astype(np.float32)
    ws = []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        ws.append(rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1)
        ws.append(rng.normal(size=(cout,)).astype(np.float32) * 0.1)
    return x, x0, ws


def _torch_args(x, x0, ws):
    def act(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    weights = [
        (torch.from_numpy(ws[2 * k].transpose(3, 2, 0, 1).copy()), torch.from_numpy(ws[2 * k + 1]))
        for k in range(5)
    ]
    return act(x), act(x0), weights


def _assert_close(got_nchw, want_nhwc):
    got = got_nchw.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want_nhwc)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())


SHAPES = [
    pytest.param(2, 8, 16, 16, 8, id="nf16-gc8-2x8x16"),
    pytest.param(2, 5, 7, 16, 8, id="nf16-gc8-ragged-2x5x7"),
    pytest.param(1, 8, 8, 64, 16, id="nf64-gc16-1x8x8"),
    pytest.param(1, 8, 8, 16, 32, id="nf16-gc32-1x8x8"),
]


@pytest.mark.parametrize("n,h,w,nf,gc", SHAPES)
def test_rdb_reference_matches_jax_reference(rng, n, h, w, nf, gc):
    x, x0, ws = _case(rng, n, h, w, nf, gc)
    tx, tx0, weights = _torch_args(x, x0, ws)
    _assert_close(rdb.rdb_reference(tx, weights), jax_rdb_reference(jnp.asarray(x), *ws))
    want_res = x0 + 0.2 * np.asarray(jax_rdb_reference(jnp.asarray(x), *ws))
    _assert_close(rdb.rdb_reference(tx, weights, tx0), want_res)


@pytest.mark.parametrize("n,h,w,nf,gc", SHAPES)
def test_rdb_reference_matches_pallas_kernels(rng, n, h, w, nf, gc):
    """The TPU kernels the CUDA kernel replaces, interpreted on the CPU."""
    x, x0, ws = _case(rng, n, h, w, nf, gc)
    tx, tx0, weights = _torch_args(x, x0, ws)
    xt, x0t = nhwc_to_cl(jnp.asarray(x)), nhwc_to_cl(jnp.asarray(x0))
    want = cl_to_nhwc(fused_rdb_t(xt, h, w, *ws, 1), n, h, w)
    _assert_close(rdb.rdb_reference(tx, weights), want)
    want_res = cl_to_nhwc(fused_rdb_res_t(xt, x0t, h, w, *ws, 1), n, h, w)
    _assert_close(rdb.rdb_reference(tx, weights, tx0), want_res)


@pytest.mark.parametrize("n", [4, 6], ids=["batch4", "batch6-tile-remainder"])
def test_fused_rdb_nhwc_matches_the_jax_kernel_d(rng, n):
    """NHWC in and out, HWIO weights, as the JAX ``fused_rdb`` (kernel D,
    interpret mode) at (n, 8, 8, 16), gc=8; ``batch_tile`` is ignored."""
    x, _, ws = _case(rng, n, 8, 8, 16, 8)
    want = np.asarray(jax_fused_rdb(jnp.asarray(x), *ws))
    rdb.fused_rdb_nhwc.launches = 0
    got = rdb.fused_rdb_nhwc(torch.from_numpy(x), *(torch.from_numpy(a) for a in ws), batch_tile=8)
    assert got.shape == (n, 8, 8, 16) and rdb.fused_rdb_nhwc.launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL_TOL * np.abs(want).max())


def test_fused_rdb_nhwc_gradients_match_the_jax_reference_vjp(rng):
    """Through FusedRDB (B1/B2's plain versions here): dx and every dW, db of
    sum(out ** 2) against ``jax.grad`` of the JAX ``fused_rdb``, 1e-4 of max."""
    x, _, ws = _case(rng, 2, 8, 8, 16, 8)
    want = jax.grad(lambda *a: jnp.sum(jax_fused_rdb(*a) ** 2), argnums=tuple(range(11)))(
        jnp.asarray(x), *(jnp.asarray(a) for a in ws))
    args = [torch.from_numpy(a.copy()).requires_grad_(True) for a in [x, *ws]]
    out = rdb.fused_rdb_nhwc(*args)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    for a, b in zip(args, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0, atol=REL_TOL * np.abs(b).max())


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(rng):
    x, x0, ws = _case(rng, 2, 6, 10, 16, 8)
    tx, tx0, weights = _torch_args(x, x0, ws)
    rdb.fused_rdb.launches = 0
    got = rdb.fused_rdb(tx, weights, tx0)
    assert rdb.fused_rdb.launches == 0
    torch.testing.assert_close(got, rdb.rdb_reference(tx, weights, tx0), rtol=0, atol=0)


def test_packed_weights_are_tap_major_hwio(rng):
    """The kernel's packing: each conv's weights as HWIO ([tap][cin][cout])
    flattened, back to back, then the biases — the flax kernels' own layout."""
    _, _, ws = _case(rng, 1, 4, 4, 16, 8)
    packed = rdb.pack_rdb_weights(_torch_args(np.zeros((1, 1, 1, 16), np.float32), np.zeros((1, 1, 1, 16), np.float32), ws)[2])
    assert (packed.nf, packed.gc) == (16, 8)
    np.testing.assert_array_equal(packed.w.numpy(), np.concatenate([ws[2 * k].ravel() for k in range(5)]))
    np.testing.assert_array_equal(packed.b.numpy(), np.concatenate([ws[2 * k + 1] for k in range(5)]))


def _assert_chain_order(weights, packed_w):
    offset = 0
    for k, (wt, _) in enumerate(weights):
        cout, cin = wt.shape[:2]
        wb = wt.to(torch.bfloat16).float().numpy()  # (cout, cin, 3, 3)
        n_words = cout * 9 * cin
        part = packed_w[offset : offset + n_words].float().numpy()
        offset += n_words
        if k == 4:
            # wgmma's B tile, K-major without swizzle (PTX ISA, wgmma shared-memory layouts): core
            # matrix (output block b, k half h) is 8 rows (outputs 8b + r) of 8 k (16 bytes), at
            # (2b + h) * 128 bytes; the kernel's descriptor says 128 bytes along K, 256 along N
            got = part.reshape(cin // 16, 9, cout // 8, 2, 8, 8)
            want = np.empty_like(got)
            for c in range(cin // 16):
                for tap in range(9):
                    for b in range(cout // 8):
                        for h in range(2):
                            for r in range(8):
                                want[c, tap, b, h, r] = wb[8 * b + r, 16 * c + 8 * h: 16 * c + 8 * h + 8,
                                                           tap // 3, tap % 3]
            np.testing.assert_array_equal(got, want)
            continue
        got = part.reshape(cin // 16, 9, cout // 16, 32, 4, 2)
        want = np.empty_like(got)
        for c in range(cin // 16):
            for tap in range(9):
                for q in range(cout // 16):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        for j in range(2):
                            for r in range(2):
                                for e in range(2):
                                    want[c, tap, q, lane, 2 * j + r, e] = wb[
                                        16 * q + 8 * j + g, 16 * c + 2 * t + 8 * r + e, tap // 3, tap % 3]
        np.testing.assert_array_equal(got, want)
    assert offset == packed_w.numel()


def test_bf16_packing_is_the_mma_b_fragment_order(rng):
    """For the tensor-core chain engine (``conv_chain``): each conv's weights,
    one after the other, k-step (ci group c, tap) after k-step, so that a ring
    slot holds whole input-channel groups with all their taps. A growth
    conv's k-step is [16-output group q][lane l][register]: lane l holds the
    b0/b1 registers of mma.m16n8k16's B fragment for two n-tiles, register r
    of n-tile j being {B[2t + 8r][g], B[2t + 8r + 1][g]} with g = l // 4, t =
    l % 4 and B[k][n] = W[16q + 8j + n][16c + k] at that tap (PTX ISA,
    m16n8k16 fragments). The last conv's k-step is wgmma's B tile (see
    ``_assert_chain_order``). At nf=16 and at the flagship nf=64 (gc=16)."""
    for nf in (16, 64):
        _, _, ws = _case(rng, 1, 4, 4, nf, 16)
        weights = _torch_args(np.zeros((1, 1, 1, nf), np.float32), np.zeros((1, 1, 1, nf), np.float32), ws)[2]
        packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
        assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
        _assert_chain_order(weights, packed.w)
    with pytest.raises(ValueError, match="16"):
        rdb.pack_rdb_weights(_torch_args(np.zeros((1, 1, 1, 16), np.float32),
                                         np.zeros((1, 1, 1, 16), np.float32), _case(rng, 1, 4, 4, 16, 8)[2])[2],
                             torch.bfloat16)


def test_b2_bf16_packing_is_the_transposed_chain_in_chain_order(rng):
    """Kernel B2 packs its input-gradient chain with one gather from the
    forward weights: transposed_chain's weights, in the chain engine's order."""
    _, _, ws = _case(rng, 1, 4, 4, 64, 16)
    weights = _torch_args(np.zeros((1, 1, 1, 64), np.float32), np.zeros((1, 1, 1, 64), np.float32), ws)[2]
    got = rdb._pack_chain(weights, transposed=True)
    assert got.dtype == torch.bfloat16
    _assert_chain_order(rdb.transposed_chain(weights), got)


def test_bf16_tile_fits_the_buffer_and_the_weight_ring():
    """At the flagship widths the 16 x 16 tile's feature buffer (26 x 26
    pixels x 136 channels) and the two 18,432-byte weight slots fit one block."""
    assert rdb._tile(64, 16, torch.bfloat16) == (16, 16)
    assert 26 * 26 * 136 * 2 + rdb._RING_BYTES == 220736 <= rdb._SMEM_LIMIT


def test_bf16_packing_at_gc32_is_the_chain_order_forward_and_transposed(rng):
    """At the reference defaults (nf=64, gc=32) a growth conv's k-step holds
    two 16-output blocks, [q][lane][register] as above; conv5 reads 12 input
    groups. Both the forward chain and kernel B2's transposed chain."""
    _, _, ws = _case(rng, 1, 4, 4, 64, 32)
    weights = _torch_args(np.zeros((1, 1, 1, 64), np.float32), np.zeros((1, 1, 1, 64), np.float32), ws)[2]
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    assert (packed.nf, packed.gc) == (64, 32) and packed.w.numel() == 239616
    _assert_chain_order(weights, packed.w)
    _assert_chain_order(rdb.transposed_chain(weights), rdb._pack_chain(weights, transposed=True))


def test_bf16_tile_at_gc32_is_8x16_within_the_budget():
    """gc=32's feature buffer (200 channels a pixel with the pad) does not fit
    at 16 x 16 (26 x 26 x 200 x 2 = 270,400 bytes) beside the 36,864-byte
    ring; 8 x 16 does (18 x 26 pixels), within the chain's M-tile limits (16 x
    24 growth pixels <= 640, 128 last-conv pixels <= 256: two 64-pixel
    M-blocks, one per warpgroup). 12 x 12 would fit too (22 x 22 pixels) but
    is not tried: it measured slower on the card. gc=48 takes 8 x 8; gc=64
    fits no tile and is refused."""
    assert rdb._RING_BYTES == 36864
    assert 26 * 26 * 200 * 2 + rdb._RING_BYTES > rdb._SMEM_LIMIT
    assert rdb._tile(64, 32, torch.bfloat16) == (8, 16)
    assert 18 * 26 * 200 * 2 + rdb._RING_BYTES == 224064 <= rdb._SMEM_LIMIT
    assert (8 + 8) * (16 + 8) <= 640 and 8 * 16 == 2 * 64
    assert (12, 12) not in rdb._TILES[torch.bfloat16]
    assert rdb._tile(64, 48, torch.bfloat16) == (8, 8)
    with pytest.raises(ValueError, match="does not fit"):
        rdb._tile(64, 64, torch.bfloat16)


@pytest.mark.parametrize("nf,gc", [(16, 16), (32, 32), (64, 64), (64, 8)], ids=["nf16", "nf32", "gc64", "gc8"])
def test_bf16_kernel_refuses_widths_the_chain_does_not_take(nf, gc):
    """The bf16 chain's last conv is wgmma with N = nf = 64 and its growth
    convs take gc in 16-output blocks up to 48: other widths raise, naming
    the roadmap, before any launch (the check the wrapper runs on a CUDA
    tensor, called here on a CPU one)."""
    x = torch.zeros(1, nf, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.zeros(8, dtype=torch.bfloat16)
    packed = rdb.PackedWeights(w, torch.zeros(4 * gc + nf), nf, gc, torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        rdb._check(x, None, packed)
    ok = rdb.PackedWeights(w, torch.zeros(4 * 32 + 64), 64, 32, torch.bfloat16)
    rdb._check(torch.zeros(1, 64, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last), None, ok)


def test_pack_rejects_inconsistent_shapes(rng):
    _, _, ws = _case(rng, 1, 4, 4, 16, 8)
    weights = _torch_args(np.zeros((1, 1, 1, 16), np.float32), np.zeros((1, 1, 1, 16), np.float32), ws)[2]
    with pytest.raises(ValueError):
        rdb.pack_rdb_weights(weights[:4])
    weights[2] = (weights[2][0][:, :-1], weights[2][1])
    with pytest.raises(ValueError):
        rdb.pack_rdb_weights(weights)


def test_wrapper_refuses_other_devices(rng):
    x, _, ws = _case(rng, 1, 4, 4, 16, 8)
    tx, _, weights = _torch_args(x, x, ws)
    with pytest.raises(ValueError):
        rdb.fused_rdb(tx.to("meta"), weights)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RDB kernel has no CPU mode (chip_smoke.py covers it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gc", [16, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain_version(rng, cuda_device, dtype, tol, gc):
    """Ragged image with tiles straddling the borders, with and without x0,
    at the flagship and the reference-default growth widths. bf16
    tolerance: cuDNN rounds each conv's output to bf16, the kernel rounds once."""
    x, x0, ws = _case(rng, 2, 45, 91, 64, gc)
    tx, tx0, weights = _torch_args(x, x0, ws)
    tx, tx0 = (t.to(cuda_device, dtype).contiguous(memory_format=torch.channels_last) for t in (tx, tx0))
    weights = [(a.to(cuda_device, dtype), b.to(cuda_device, dtype)) for a, b in weights]
    before = rdb.fused_rdb.launches
    for res in (None, tx0):
        got = rdb.fused_rdb(tx, weights, res).float()
        ref = rdb.rdb_reference(tx, weights, res).float()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert rdb.fused_rdb.launches == before + 2
    with pytest.raises(ValueError):
        rdb.fused_rdb(tx.contiguous(), weights)  # NCHW-contiguous is refused, not converted
    before = rdb.fused_rdb_nhwc.launches
    hwio = [t.to(cuda_device, dtype) for t in (torch.from_numpy(a) for a in ws)]
    got = rdb.fused_rdb_nhwc(tx.permute(0, 2, 3, 1), *hwio).float()
    ref = rdb.rdb_reference(tx, weights).float().permute(0, 2, 3, 1)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert rdb.fused_rdb_nhwc.launches == before + 1
