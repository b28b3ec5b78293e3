# -*- coding: utf-8 -*-
"""Fused residual dense block (RDB) forward: CUDA kernel and its plain version.

One RDB is four 3x3 growth convs (cin = nf + k*gc -> gc, bias, LeakyReLU 0.2)
over the growing concatenation ``[x, h_1, ..., h_k]``, then conv5 (nf + 4*gc ->
nf) and the residual ``x + 0.2 * conv5``. With ``x0`` the enclosing RRDB's
residual is folded into the same write: ``x0 + 0.2 * (x + 0.2 * conv5)``.

- :func:`rdb_reference` is the plain PyTorch version (``torch.nn.functional``
  convs and concatenations). It runs every tensor on the CPU and is the
  yardstick the kernel is held against on the card.
- :func:`fused_rdb` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/rdb_fwd.cu`` (which replaces the TPU kernel
  ``_rdb_t_kernel``/``_rdb_t_forward_body`` of
  ``climsr_tpu/ops/pallas/rdb.py:190,326``) or raises; for a CPU tensor it
  calls :func:`rdb_reference`. It counts its launches in ``fused_rdb.launches``.

What bounds the kernel on an H100, and what its design does about it, is
written at the top of ``csrc/rdb_fwd.cu``: the block is bound by operations
(about 124k MAC per pixel against 6 bytes of traffic per channel-pixel in bf16),
and the kernel keeps the whole concatenation in shared memory so that only x,
x0 and the output cross device memory. bf16 runs on the tensor cores
(``mma.sync``), float32 on the CUDA cores.

Tensors are NCHW in ``torch.channels_last`` memory format (NHWC storage), so
the cuDNN convs around the trunk and the kernel share one layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]  # five (OIHW weight, bias) pairs

_SOURCES = ("rdb_fwd.cu",)
_HALO = 5
_PAD = 8  # bf16 buffer channels per pixel: nf + 4*gc + _PAD (spreads ldmatrix rows over the banks)
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# output tiles (th, tw) tried in order; the first whose feature buffer fits is used
_TILES = {
    torch.bfloat16: ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4)),
    torch.float32: ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2)),
}


def rdb_reference(x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain RDB forward in x's dtype; the same semantics as the kernel."""

    def conv(v, wb):
        return F.conv2d(v, wb[0].to(v.dtype), wb[1].to(v.dtype), padding=1)

    feats = [x]
    for k in range(4):
        feats.append(F.leaky_relu(conv(torch.cat(feats, dim=1), weights[k]), 0.2))
    out = conv(torch.cat(feats, dim=1), weights[4]) * 0.2 + x
    if x0 is not None:
        out = out * 0.2 + x0
    return out


class PackedWeights(NamedTuple):
    """The five convs' weights packed for the kernel of one dtype, back to
    back, and the biases ``[b1..b4, b5]`` in float32.

    - float32: tap-major per conv, ``[3*ky + kx][cin][cout]`` (HWIO).
    - bfloat16: the tensor cores' B-fragment order (:func:`fragment_index`).
    """

    w: torch.Tensor
    b: torch.Tensor
    nf: int
    gc: int
    dtype: torch.dtype


def fragment_index(cout: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, k) indices of a (cout, K) weight matrix in ``mma.m16n8k16`` B-fragment
    order, shaped [cout/16][K/16][32 lanes][4 words][2 halves].

    Lane ``l`` (g = l // 4, t = l % 4) of k-step ``s`` for output channels
    16q..16q+15 holds, in four 32-bit words (low half first), B[k][n] for
    n = 16q + g (words 0, 1) and 16q + 8 + g (words 2, 3), k = 16s + 2t + half
    (words 0, 2) and 16s + 2t + 8 + half (words 1, 3): the b0/b1 registers of
    two n-tiles of 8, so each lane reads one 16-byte vector per k-step.
    """
    q = torch.arange(cout // 16).view(-1, 1, 1, 1, 1)
    s = torch.arange(k // 16).view(1, -1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1, 1)
    word = torch.arange(4).view(1, 1, 1, -1, 1)
    half = torch.arange(2).view(1, 1, 1, 1, -1)
    n_idx = 16 * q + lane // 4 + 8 * (word // 2)
    k_idx = 16 * s + 2 * (lane % 4) + 8 * (word % 2) + half
    shape = (cout // 16, k // 16, 32, 4, 2)
    return n_idx.expand(shape).reshape(-1), k_idx.expand(shape).reshape(-1)


def pack_rdb_weights(weights: Weights, dtype: torch.dtype = torch.float32) -> PackedWeights:
    """Pack the (OIHW weight, bias) pairs for the kernel of ``dtype``, on their device."""
    if len(weights) != 5:
        raise ValueError(f"an RDB has five convs, got {len(weights)}")
    gc, nf = weights[0][0].shape[0], weights[4][0].shape[0]
    for k, (wt, bs) in enumerate(weights):
        cout = gc if k < 4 else nf
        want = (cout, nf + k * gc, 3, 3)
        if tuple(wt.shape) != want or tuple(bs.shape) != (cout,):
            raise ValueError(f"conv{k + 1}: weight {tuple(wt.shape)} / bias {tuple(bs.shape)}, expected {want}")
    b = torch.cat([bs.detach().float().reshape(-1) for _, bs in weights]).contiguous()
    if dtype == torch.float32:
        w = torch.cat([wt.detach().float().permute(2, 3, 1, 0).reshape(-1) for wt, _ in weights])
    elif dtype == torch.bfloat16:
        if nf % 16 or gc % 16:
            raise ValueError(f"the bf16 kernel needs nf and gc divisible by 16, got nf={nf}, gc={gc}")
        parts = []
        for wt, _ in weights:
            cout, cin = wt.shape[:2]
            wk = wt.detach().to(torch.bfloat16).permute(0, 2, 3, 1).reshape(cout, 9 * cin)  # k = tap*cin + ci
            n_idx, k_idx = fragment_index(cout, 9 * cin)
            parts.append(wk[n_idx.to(wk.device), k_idx.to(wk.device)])
        w = torch.cat(parts)
    else:
        raise TypeError(f"the RDB kernel takes float32 or bfloat16, got {dtype}")
    return PackedWeights(w.contiguous(), b, nf, gc, dtype)


def _tile(nf: int, gc: int, dtype: torch.dtype) -> Tuple[int, int]:
    for th, tw in _TILES[dtype]:
        ph, pw = th + 2 * _HALO, tw + 2 * _HALO
        if dtype == torch.bfloat16:
            smem = ph * pw * (nf + 4 * gc + _PAD) * 2
        else:
            smem = (nf + 4 * gc) * ph * pw * 4
        if smem <= _SMEM_LIMIT:
            return th, tw
    raise ValueError(f"nf={nf}, gc={gc}: the feature buffer does not fit in shared memory at any tile")


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_rdb", _SOURCES)
    fn = lib.climsr_rdb_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, x0: Optional[torch.Tensor], packed: PackedWeights) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_rdb takes an (N, C, H, W) tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_rdb kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_rdb kernel needs x in torch.channels_last memory format")
    if x.shape[1] != packed.nf:
        raise ValueError(f"x has {x.shape[1]} channels, the weights expect nf={packed.nf}")
    step = 16 if x.dtype == torch.bfloat16 else 8
    if packed.nf % step or packed.gc % step:
        raise ValueError(f"fused_rdb kernel needs nf and gc divisible by {step} in {x.dtype}, "
                         f"got nf={packed.nf}, gc={packed.gc}")
    if x.shape[0] > 65535:
        raise ValueError(f"fused_rdb kernel takes at most 65535 images per launch, got {x.shape[0]}")
    if packed.dtype != x.dtype or packed.w.dtype != x.dtype or packed.b.dtype != torch.float32:
        raise ValueError(f"weights packed for {packed.dtype}, x is {x.dtype}")
    for name, t in (("w", packed.w), ("b", packed.b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"packed {name} must be a contiguous tensor on {x.device}")
    if x0 is not None:
        if x0.shape != x.shape or x0.dtype != x.dtype or x0.device != x.device:
            raise ValueError("x0 must match x in shape, dtype and device")
        if not x0.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("fused_rdb kernel needs x0 in torch.channels_last memory format")
    for name, t in (("x", x), ("x0", x0), ("packed weights", packed.w)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fused_rdb kernel needs {name} 16-byte aligned")


def fused_rdb(
    x: torch.Tensor,
    weights: Weights,
    x0: Optional[torch.Tensor] = None,
    packed: Optional[PackedWeights] = None,
) -> torch.Tensor:
    """One RDB forward (``x0 + 0.2 * rdb(x)`` when ``x0`` is given).

    ``x``/``x0``: (N, nf, H, W). On a CUDA tensor this launches the kernel on
    the current stream (``packed`` saves re-packing the weights on every
    call); it never falls back. On a CPU tensor it runs :func:`rdb_reference`.
    """
    if x.device.type == "cpu":
        return rdb_reference(x, weights, x0)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb runs on CUDA or CPU tensors, got {x.device}")
    if packed is None:
        packed = pack_rdb_weights(weights, x.dtype)
    _check(x, x0, packed)
    n, nf, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    th, tw = _tile(packed.nf, packed.gc, x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.climsr_rdb_fwd(
            x.data_ptr(), None if x0 is None else x0.data_ptr(), out.data_ptr(),
            packed.w.data_ptr(), packed.b.data_ptr(),
            n, h, w, packed.nf, packed.gc, th, tw, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rdb kernel launch failed: CUDA error {err}")
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0  # kernel launches since the count was last reset
