# -*- coding: utf-8 -*-
"""The port's fused RDB (climsr_tpu_torch.ops.rdb) against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against the
JAX ``rdb_reference`` and the Pallas kernels ``fused_rdb_t`` /
``fused_rdb_res_t`` run in interpret mode, on the same numpy inputs, in f32.
Tolerance: 1e-4 of max|ref| (summation order only). The CUDA kernel itself is
compared with the plain version on the card (``chip_smoke.py`` and the
``cuda``-marked test below).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from climsr_tpu.ops.pallas.rdb import cl_to_nhwc, fused_rdb_res_t, fused_rdb_t, nhwc_to_cl
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


def test_bf16_packing_is_the_mma_b_fragment_order(rng):
    """For the tensor-core kernel: per group of 16 output channels and k-step
    of 16 (k = tap*cin + ci), lane l holds the b0/b1 registers of
    mma.m16n8k16's B fragment for two n-tiles: register r of n-tile j is
    {B[2t + 8r][g], B[2t + 8r + 1][g]} with g = l // 4, t = l % 4 and
    B[k][n] = W[16q + 8j + n][16s + k] (PTX ISA, m16n8k16 fragments)."""
    nf, gc = 16, 16
    _, _, ws = _case(rng, 1, 4, 4, nf, gc)
    weights = _torch_args(np.zeros((1, 1, 1, nf), np.float32), np.zeros((1, 1, 1, nf), np.float32), ws)[2]
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
    offset = 0
    for wt, _ in weights:
        cout, cin = wt.shape[:2]
        wk = wt.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(cout, 9 * cin).float().numpy()
        n_words = cout * 9 * cin
        got = packed.w[offset : offset + n_words].float().numpy().reshape(cout // 16, 9 * cin // 16, 32, 4, 2)
        offset += n_words
        want = np.empty_like(got)
        for q in range(cout // 16):
            for s in range(9 * cin // 16):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for j in range(2):
                        for r in range(2):
                            for e in range(2):
                                want[q, s, lane, 2 * j + r, e] = wk[16 * q + 8 * j + g, 16 * s + 2 * t + 8 * r + e]
        np.testing.assert_array_equal(got, want)
    assert offset == packed.w.numel()
    with pytest.raises(ValueError, match="16"):
        rdb.pack_rdb_weights(_torch_args(np.zeros((1, 1, 1, 16), np.float32),
                                         np.zeros((1, 1, 1, 16), np.float32), _case(rng, 1, 4, 4, 16, 8)[2])[2],
                             torch.bfloat16)


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain_version(rng, cuda_device, dtype, tol):
    """Ragged image with tiles straddling the borders, with and without x0.
    bf16 tolerance: cuDNN rounds each conv's output to bf16, the kernel rounds once."""
    x, x0, ws = _case(rng, 2, 45, 91, 64, 16)
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
