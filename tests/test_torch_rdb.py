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


def _unpack_chain(packed_w, nf, gc, depth):
    """Walk the bf16 chain's weight stream as the kernels consume it
    (``csrc/rdb_common.cuh``: ``WeightStream``, ``growth_products``,
    ``last_pass``), chunk after chunk of at most 64 columns (one ring slot),
    and put every element back at its (output, input, ky, kx) in its conv's
    OIHW weight. Growth step t of a group of ``depth`` convs (a = t // depth *
    depth) feeds convs t .. a + depth - 1 from channels [0, nf + t*gc) at the
    group's first step and from h_t's gc channels at the others; element
    (((gl * 9 + tap) * NP + p) * NQ + q) * 32 + lane) * 8 + 2 * word + half of a
    chunk is mma.m16n8k16's B[k][n] of pending conv p (PTX ISA, m16n8k16
    fragments), n = 16q + 8 (word // 2) + lane // 4, k = 2 (lane % 4) + 8 (word %
    2) + half of the chunk's channel group gl. The last conv's passes (at most
    64 outputs) follow, each k-step wgmma's K-major B tile without swizzle: core
    matrix (output block b, k half h) is 8 rows (outputs 8b + r) of 8 k (16
    bytes) at (2b + h) * 128 bytes. Returns the five weights and how often each
    element was written."""
    w = packed_w.float().numpy()
    convs = [np.zeros((gc if k < 4 else nf, nf + k * gc, 3, 3), np.float32) for k in range(5)]
    hits = [np.zeros(c.shape, np.int64) for c in convs]
    pos = 0

    def put(conv, n, ci, tap, values):
        np.add.at(hits[conv], (n, ci, tap // 3, tap % 3), 1)
        convs[conv][n, ci, tap // 3, tap % 3] = values

    nq = gc // 16
    for t in range(4):
        a = t // depth * depth
        fed = list(range(t, a + depth))
        ch0, channels = (0, nf + t * gc) if t == a else (nf + (t - 1) * gc, gc)
        cols = len(fed) * gc
        assert cols <= 64  # a k-step fits one ring slot
        per, groups = 64 // cols, channels // 16
        for k0 in range(0, groups, per):
            ng = min(per, groups - k0)
            size = ng * 9 * cols * 16
            chunk = w[pos:pos + size].reshape(ng, 9, len(fed), nq, 32, 4, 2)
            pos += size
            gl, tap, p, q, lane, word, half = np.meshgrid(*(np.arange(d) for d in chunk.shape), indexing="ij")
            n = 16 * q + 8 * (word // 2) + lane // 4
            ci = ch0 + 16 * (k0 + gl) + 2 * (lane % 4) + 8 * (word % 2) + half
            for i, conv in enumerate(fed):
                sel = p == i
                put(conv, n[sel], ci[sel], tap[sel], chunk[sel])
    cin = nf + 4 * gc
    for n0 in range(0, nf, 64):
        nn = min(64, nf - n0)
        per, groups = 64 // nn, cin // 16
        for k0 in range(0, groups, per):
            ng = min(per, groups - k0)
            size = ng * 9 * 16 * nn
            chunk = w[pos:pos + size].reshape(ng, 9, nn // 8, 2, 8, 8)
            pos += size
            gl, tap, b, h, r, kr = np.meshgrid(*(np.arange(d) for d in chunk.shape), indexing="ij")
            put(4, n0 + 8 * b + r, 16 * (k0 + gl) + 8 * h + kr, tap, chunk)
    assert pos == w.size  # the stream ends where the packing does
    return convs, hits


def _assert_chain_order(weights, packed_w, depth=None):
    """``packed_w`` is the bf16 chain's stream of ``weights`` (five OIHW
    convs in the forward chain's shapes) at the wrapper's growth depth: every
    streamed chunk unpacks back to the weights, each element once."""
    gc, nf = weights[0][0].shape[0], weights[4][0].shape[0]
    depth = rdb._chain_depth(nf, gc) if depth is None else depth
    convs, hits = _unpack_chain(packed_w, nf, gc, depth)
    for k, (wt, _) in enumerate(weights):
        assert (hits[k] == 1).all(), f"conv{k + 1}: an element is missing or streamed twice"
        np.testing.assert_array_equal(convs[k], wt.to(torch.bfloat16).float().numpy())


def test_bf16_packing_is_the_mma_b_fragment_order(rng):
    """For the tensor-core chain engine (``conv_chain``): growth step after
    growth step, source-major at depth 2 (gc=16), then the last conv, k-step
    (channel group c, tap) after k-step, so that a ring slot holds whole
    channel groups with all their taps. A growth step's k-step is [pending
    conv p][16-output group q][lane l][register]: lane l holds the b0/b1
    registers of mma.m16n8k16's B fragment for two n-tiles, register r of
    n-tile j being {B[2t + 8r][g], B[2t + 8r + 1][g]} with g = l // 4, t = l %
    4 and B[k][n] = W_p[16q + 8j + n][16c + k] at that tap (PTX ISA, m16n8k16
    fragments). x's four groups feed growth convs 1 and 2 (32 columns, two
    groups a slot). The last conv's k-step is wgmma's B tile (see
    ``_unpack_chain``). At nf=16 and at the flagship nf=64 (gc=16)."""
    for nf in (16, 64):
        _, _, ws = _case(rng, 1, 4, 4, nf, 16)
        weights = _torch_args(np.zeros((1, 1, 1, nf), np.float32), np.zeros((1, 1, 1, nf), np.float32), ws)[2]
        packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
        assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
        assert rdb._chain_depth(nf, 16) == 2
        _assert_chain_order(weights, packed.w, depth=2)
        # the first k-step is x's first channel group at the first tap, for growth convs 1 and 2 at once
        first = packed.w[:9 * 16 * 32].float().view(9, 2, 32, 4, 2)
        for conv in range(2):
            assert torch.equal(first[4, conv, 0, 0], weights[conv][0][0, :2, 1, 1].to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="16"):
        rdb.pack_rdb_weights(_torch_args(np.zeros((1, 1, 1, 16), np.float32),
                                         np.zeros((1, 1, 1, 16), np.float32), _case(rng, 1, 4, 4, 16, 8)[2])[2],
                             torch.bfloat16)


def test_b2_bf16_packing_is_the_transposed_chain_in_chain_order(rng):
    """Kernel B2 packs its input-gradient chain with one gather from the
    forward weights: transposed_chain's weights, in the chain engine's
    source-major order (depth 2 at gc=16), as kernel A's."""
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
    """At the reference defaults (nf=64, gc=32) the growth depth is 2: x's
    groups feed convs 1 and 2 (two 16-output blocks each, 64 columns), h_1
    conv 2, then x, h_1 and h_2 feed convs 3 and 4 and h_3 conv 4; conv5
    reads 12 input groups. Both the forward chain and kernel B2's transposed
    chain."""
    _, _, ws = _case(rng, 1, 4, 4, 64, 32)
    weights = _torch_args(np.zeros((1, 1, 1, 64), np.float32), np.zeros((1, 1, 1, 64), np.float32), ws)[2]
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    assert (packed.nf, packed.gc) == (64, 32) and packed.w.numel() == 239616
    assert rdb._chain_depth(64, 32) == 2
    assert [(f, n, fed) for f, n, fed in rdb.growth_steps(64, 32, 2)] == [
        (0, 64, (0, 1)), (64, 32, (1,)), (0, 128, (2, 3)), (128, 32, (3,))]
    _assert_chain_order(weights, packed.w, depth=2)
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


@pytest.mark.parametrize("nf,gc", [(144, 16), (24, 32), (64, 64), (64, 8)], ids=["nf144", "nf24", "gc64", "gc8"])
def test_bf16_kernel_refuses_widths_the_chain_does_not_take(nf, gc):
    """The bf16 chain's last conv is wgmma in passes of at most 64 outputs
    (two at most, so nf a multiple of 16 up to 128) and its growth convs take
    gc in 16-output blocks up to 48: other widths raise, naming the
    combination, before any launch (the check the wrapper runs on a CUDA
    tensor, called here on a CPU one)."""
    x = torch.zeros(1, nf, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.zeros(8, dtype=torch.bfloat16)
    packed = rdb.PackedWeights(w, torch.zeros(4 * gc + nf), nf, gc, torch.bfloat16)
    with pytest.raises(ValueError, match=f"nf={nf}, gc={gc} does not fit"):
        rdb._check(x, None, packed)
    ok = rdb.PackedWeights(w, torch.zeros(4 * 32 + 64), 64, 32, torch.bfloat16)
    rdb._check(torch.zeros(1, 64, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last), None, ok)


WIDTHS = [pytest.param(nf, gc, id=f"nf{nf}-gc{gc}") for nf in (16, 32, 48, 80, 96, 112, 128) for gc in (16, 32, 48)]


@pytest.mark.parametrize("nf,gc", WIDTHS)
def test_bf16_chain_plan_at_other_widths(nf, gc):
    """Fault 1 closed: the bf16 chain takes every nf a multiple of 16 up to
    128 at gc = 16, 32, 48. The last conv's passes (wgmma's N <= 64), the
    stream's chunks (the ring's two 64-column slots) and the tile: the first
    of ``_TILES`` whose buffer (nf + 4*gc + 8 channels a pixel, a 5-pixel
    halo) fits beside the 36,864-byte ring in 232,448 bytes, within the
    chain's M-tile limits, and no larger tile fits."""
    passes = rdb.last_passes(nf)
    assert sum(n for _, n in passes) == nf and all(n in (16, 32, 48, 64) for _, n in passes)
    assert [n0 for n0, _ in passes] == list(range(0, nf, 64)) and len(passes) == (1 if nf <= 64 else 2)
    for _, n in passes:  # a chunk (one ring slot) holds 64 // n whole 16-input groups of a pass
        assert 64 // n >= 1 and (64 // n) * 9 * 16 * n * 2 <= rdb._RING_BYTES // 2
    th, tw = rdb._tile(nf, gc, torch.bfloat16)
    cp = nf + 4 * gc + 8

    def smem(t):
        return (t[0] + 10) * (t[1] + 10) * cp * 2 + rdb._RING_BYTES

    assert smem((th, tw)) <= rdb._SMEM_LIMIT
    assert (th + 8) * (tw + 8) <= 16 * 8 * 5 and th * tw <= 16 * 8 * 2
    # the growth sums' registers: at most 5, 3, 2 M-tiles of region 0 a warp at gc = 16, 32, 48 (``kMaxMT``)
    assert (th + 8) * (tw + 8) <= 16 * 8 * {16: 5, 32: 3, 48: 2}[gc]
    tiles = rdb._TILES[torch.bfloat16]
    assert all(smem(t) > rdb._SMEM_LIMIT for t in tiles[:tiles.index((th, tw))])
    if (nf, gc) in ((112, 48), (128, 48)):
        assert (th, tw) == (4, 8)


@pytest.mark.parametrize("nf,gc", [(32, 16), (48, 32), (96, 16), (128, 32)], ids=["nf32", "nf48", "nf96", "nf128"])
def test_bf16_packing_at_other_widths_is_the_chain_order(rng, nf, gc):
    """The forward chain and kernel B2's transposed chain at widths other
    than 64: growth steps source-major in the mma.sync B-fragment order, the
    last conv as wgmma B tiles of each pass (two passes at nf=96 and 128:
    outputs 0-63, then the rest), decoded chunk by chunk."""
    _, _, ws = _case(rng, 1, 4, 4, nf, gc)
    weights = _torch_args(np.zeros((1, 1, 1, nf), np.float32), np.zeros((1, 1, 1, nf), np.float32), ws)[2]
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    assert packed.w.numel() == 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)
    _assert_chain_order(weights, packed.w)
    _assert_chain_order(rdb.transposed_chain(weights), rdb._pack_chain(weights, transposed=True))


@pytest.mark.parametrize("nf,gc", WIDTHS)
def test_bf16_source_major_packing_at_every_width(rng, nf, gc):
    """At every width the chain takes besides nf=64 (nf 16-128 x gc 16, 32,
    48), forward and transposed: the stream at the wrapper's depth (2 at
    gc=16 and 32, 1 at gc=48) unpacks, chunk by chunk, back to the OIHW
    weights, each element once; and its growth steps are the source-major
    ones, x's channel groups feeding every conv of the first group."""
    _, _, ws = _case(rng, 1, 4, 4, nf, gc)
    weights = _torch_args(np.zeros((1, 1, 1, nf), np.float32), np.zeros((1, 1, 1, nf), np.float32), ws)[2]
    depth = rdb._chain_depth(nf, gc)
    assert depth == {16: 2, 32: 2, 48: 1}[gc]
    steps = rdb.growth_steps(nf, gc, depth)
    assert steps[0] == (0, nf, tuple(range(depth)))
    assert [fed[0] for _, _, fed in steps] == [0, 1, 2, 3]  # step c completes conv c
    _assert_chain_order(weights, rdb.pack_rdb_weights(weights, torch.bfloat16).w, depth)
    _assert_chain_order(rdb.transposed_chain(weights), rdb._pack_chain(weights, transposed=True), depth)


def test_growth_depth_by_width_and_tile():
    """The wrapper picks how many growth convs one read of a buffer slice
    feeds: the most of 4, 2, 1 whose k-step (depth x gc outputs) fits the ring
    slot's 64 columns and whose pending sums (depth x gc / 2 f32 registers a
    thread per M-tile a warp holds in region 0: 5, 3, 2 at gc = 16, 32, 48)
    fit in 96. The presets' widths take the source-major step: nf=64 at gc=16
    (flagship, GAN, sweep; 16 x 16 tiles, 36 M-tiles of region 0, 5 a warp)
    and at gc=32 (the paper's; 8 x 16, 24 M-tiles, 3 a warp), both at depth 2
    (depth 4 at gc=16 would hold 160 registers of sums). The per-conv step
    (depth 1) is left only at gc=48, every nf (8 x 8, and 4 x 8 at nf=112
    and 128), where two convs' 96 columns do not fit a slot. Every tile the
    wrapper picks holds at most the M-tiles the depth was sized for."""
    assert (rdb._tile(64, 16, torch.bfloat16), rdb._chain_depth(64, 16)) == ((16, 16), 2)
    assert (rdb._tile(64, 32, torch.bfloat16), rdb._chain_depth(64, 32)) == ((8, 16), 2)
    assert 4 * 8 * 5 > rdb._PENDING_REGS >= 2 * 8 * 5 and 2 * 16 * 3 <= rdb._PENDING_REGS
    fallback = []
    for nf in range(16, 129, 16):
        for gc in (16, 32, 48):
            th, tw = rdb._tile(nf, gc, torch.bfloat16)
            depth = rdb._chain_depth(nf, gc)
            assert depth == rdb.growth_depth(gc) and depth * gc <= 64
            assert -(-(th + 8) * (tw + 8) // 16) <= 8 * rdb._GROWTH_MT[gc]
            if depth == 1:
                fallback.append((nf, gc))
    assert fallback == [(nf, 48) for nf in range(16, 129, 16)]


@pytest.mark.parametrize("nf,gc", [(16, 16), (96, 32), (128, 48)], ids=["nf16", "nf96", "nf128-gc48"])
def test_b2_wgrad_plan_at_other_widths(nf, gc):
    """Kernel B2's dW jobs at other widths: one row per 16 channels of z and
    part of its conv's inputs, every part whole 16-channel groups of at most
    128, the parts of each group tiling the conv's inputs exactly once, and
    the weight offsets those of the OIHW convs back to back."""
    jobs, bounds = rdb.wgrad_plan(2, 7, 33, nf, gc, 3)
    total = nf + 4 * gc
    covered = {}
    sizes = [9 * (gc if k < 4 else nf) * (nf + k * gc) for k in range(5)]
    for zc, j, co0, cin, woff, ci0, cic in jobs.tolist():
        assert cin == nf + j * gc and 16 <= cic <= 128 and cic % 16 == 0 and ci0 % 16 == 0
        assert woff == sum(sizes[:j])
        assert (zc < nf) == (j == 4) and co0 == (zc if j == 4 else (zc - nf) % gc)
        covered.setdefault(zc, []).append((ci0, cic))
    assert sorted(covered) == list(range(0, total, 16))
    for zc, parts in covered.items():
        parts.sort()
        assert parts[0][0] == 0 and all(a + n == b for (a, n), (b, _) in zip(parts, parts[1:]))
        assert sum(n for _, n in parts) == jobs[jobs[:, 0] == zc][0, 3].item()
    assert bounds.tolist() == [0, 2, 4, 6]  # 2 images x 1 x 3 tiles of 8 x 16, in three splits


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


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc", [(32, 16), (96, 32), (128, 48)], ids=["nf32", "nf96", "nf128-gc48"])
def test_cuda_bf16_kernels_at_other_widths(rng, cuda_device, nf, gc):
    """Fault 1 on the card: kernels A and B1/B2 in bf16 at nf other than 64
    on a ragged image, against their plain versions (tolerances as
    ``chip_smoke.py`` phases 3 and 6)."""
    x, x0, ws = _case(rng, 2, 29, 45, nf, gc)
    tx, tx0, weights = _torch_args(x, x0, ws)
    tx, tx0 = (t.to(cuda_device, torch.bfloat16).contiguous(memory_format=torch.channels_last) for t in (tx, tx0))
    weights = [(a.to(cuda_device, torch.bfloat16), b.to(cuda_device, torch.bfloat16)) for a, b in weights]
    for res in (None, tx0):
        got = rdb.fused_rdb(tx, weights, res).float()
        ref = rdb.rdb_reference(tx, weights, res).float()
        assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    out, feat = rdb.fused_rdb_fwd_save(tx, weights)
    ref_out, ref_feat = rdb.rdb_fwd_save_reference(tx, weights)
    assert (feat.float() - ref_feat.float()).abs().max().item() <= 3e-2 * ref_feat.float().abs().max().item()
    g = (0.01 * torch.randn(tx.shape, generator=torch.Generator().manual_seed(0))).to(
        cuda_device, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dx, dws, dbs = rdb.fused_rdb_bwd(feat, g, weights, 0.2, 1.0)
    ref_dx, ref_dws, ref_dbs = rdb.rdb_bwd_reference(feat, g, weights, 0.2, 1.0)
    for a, b in zip([dx, *dws, *dbs], [ref_dx, *ref_dws, *ref_dbs]):
        assert (a.float() - b.float()).abs().max().item() <= 3e-2 * b.float().abs().max().item()
