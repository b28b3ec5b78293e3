# -*- coding: utf-8 -*-
"""Fused residual dense block (RDB): CUDA kernels, their plain versions and autograd.

One RDB is four 3x3 growth convs (cin = nf + k*gc -> gc, bias, LeakyReLU 0.2)
over the growing concatenation ``[x, h_1, ..., h_k]``, then conv5 (nf + 4*gc ->
nf) and the residual ``x + 0.2 * conv5``. With ``x0`` the enclosing RRDB's
residual is folded into the same write: ``x0 + 0.2 * (x + 0.2 * conv5)``.
A bias of None is a conv without one (RFB-ESRGAN's bias-free RDB): the kernels
run it on zero biases, and no gradient is returned for it.

- :func:`rdb_reference` is the plain PyTorch version (``torch.nn.functional``
  convs and concatenations). It runs every tensor on the CPU and is the
  yardstick the kernel is held against on the card.
- :func:`fused_rdb` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel A, ``csrc/rdb_fwd.cu`` (which replaces the TPU kernel
  ``_rdb_t_kernel``/``_rdb_t_forward_body`` of
  ``climsr_tpu/ops/pallas/rdb.py:190,326``) or raises; for a CPU tensor it
  calls :func:`rdb_reference`. It counts its launches in ``fused_rdb.launches``.
  Where autograd needs the block's gradient it goes through :class:`FusedRDB`
  instead, on either device, so no call cuts the graph.
- Training (the counterpart of ``fused_rdb_t``/``fused_rdb_res_t`` and their
  ``custom_vjp``, ``rdb.py:570-612``): :class:`FusedRDB`'s forward is
  :func:`fused_rdb_fwd_save`, kernel B1 (``climsr_rdb_fwd_save`` in
  ``csrc/rdb_fwd.cu``, replacing ``_rdb_t_fwd_save_kernel`` ``rdb.py:315``),
  which also returns the feature buffer ``feat = [x, h_1 .. h_4]``; its
  backward is :func:`fused_rdb_bwd`, kernel B2 (``csrc/rdb_bwd.cu``, replacing
  ``_rdb_t_bwd_kernel`` ``rdb.py:432``). Their plain versions are
  :func:`rdb_fwd_save_reference` and :func:`rdb_bwd_reference` (explicit conv
  algebra, not autograd).
- :func:`fused_rdb_nhwc` is the JAX package's public ``fused_rdb`` (TPU kernel
  D, ``_rdb_kernel`` ``rdb.py:83``): NHWC in and out, HWIO weights. D computes
  A's function in another TPU layout, so on the card it launches kernel A.

What bounds the kernels on an H100, and what their design does about it, is
written at the top of ``csrc/rdb_fwd.cu`` and ``csrc/rdb_bwd.cu``. In short:
the block is bound by operations (about 124k MAC per pixel at gc=16, 240k at
gc=32, against 6 bytes of traffic per channel-pixel in bf16), and the kernels
keep the whole concatenation in shared memory so that only x, x0 and the
output (and, in training, feat and z) cross device memory. In bf16 A, B1 and
B2's input-gradient pass share one conv chain (``csrc/rdb_common.cuh``
``conv_chain``), which takes nf a multiple of 16 from 16 to 128 and gc a
multiple of 16 up to 48 (the repo's ESRGAN configs: nf=64 with gc=16 in
``conf/generator/esrgan.yaml`` and gc=32 in ``GeneratorConfig``'s defaults):
the weights, packed once in :func:`growth_steps` and :func:`chain_index`'s
order, stream through a two-slot ring in shared memory; the gc-channel growth
convs run source-major on ``mma.sync``, :func:`growth_depth` convs at a time
(one A fragment of a buffer slice feeds gc/8 n-tiles of each: 2 convs at
gc=16 and 32, the per-conv step at gc=48), and the nf-channel last conv on
``wgmma`` in passes of at most 64 outputs (:func:`last_passes`). The output
tile is the first of ``_TILES`` whose buffer fits beside the ring
(:func:`_tile`): at nf=64, 16 x 16 at gc=16 (220,736 of the 232,448 bytes a
block may use), 8 x 16 at gc=32 (224,064; ~1.53x halo recompute against
~1.27x), 8 x 8 at gc=48; 4 x 8 where the buffer is widest (nf=112 and 128 at
gc=48); one block per SM. B2's weight gradient stages each pixel tile once for all nine taps, one
block per (16 outputs, at most 128 inputs) job and split of the pixels, given
by :func:`wgrad_plan`, with per-split f32 partials summed in a fixed order (no
atomics); its two 55,104-byte stages fit two blocks per SM. What still holds
them back is the growth products on ``mma.sync`` (about half ``wgmma``'s rate,
and more of them source-major), the last conv's ``wgmma`` pipeline one tap
deep, x's load and the epilogues with nothing to overlap them, and the halo
recompute. float32 runs on the CUDA cores, at any widths divisible by 16 (by 8
forward). The launches whose growth convs ran source-major are counted in each
entry point's ``.source_major`` and in ``climsr.rdb.source_major.<kernel>``.

Tensors are NCHW in ``torch.channels_last`` memory format (NHWC storage), so
the cuDNN convs around the trunk and the kernel share one layout.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib
from climsr_tpu_torch.utils import profiling

Weights = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]  # five (OIHW weight, bias or None) pairs

_SOURCES = ("rdb_fwd.cu",)  # kernels A and B1
_BWD_SOURCES = ("rdb_bwd.cu",)  # kernel B2
_MAX_SPLITS = 32  # kernel B2's f32 dW partials: at most this many splits of the pixels
_WGRAD_TILE = (8, 16)  # kernel B2's bf16 dW pass: pixel tiles of 8 rows x 16 columns (kTH, kTW)
_WGRAD_MAX_CIN = 128  # kernel B2's bf16 dW pass: input channels per job (kMaxCic)
_HALO = 5
_PAD = 8  # bf16 buffer channels per pixel: nf + 4*gc + _PAD (spreads ldmatrix rows over the banks)
_RING_BYTES = 2 * 9 * 16 * 64 * 2  # bf16 chain: two weight slots of 9 taps x 16 inputs x 64 outputs
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# the bf16 chain (``chain_fits``): nf a multiple of 16 up to 128 (the last conv in
# passes of at most _LAST_PASS outputs, wgmma's N), gc a multiple of 16 up to 48,
# and each conv's 16-pixel M-tiles within 8 warps x 5, 3, 2 at gc 16, 32, 48 (growth) and 8 x 2 (last)
_CHAIN_MAX_NF, _CHAIN_MAX_GC, _LAST_PASS = 128, 48, 64
_GROWTH_MT, _LAST_MTILES = {16: 5, 32: 3, 48: 2}, 8 * 2  # growth: M-tiles a warp holds, by gc (``kMaxMT``)
_SLOT_COLS = 64  # bf16 chain: weight columns (outputs) a k-step of one ring slot holds
_PENDING_REGS = 96  # bf16 chain: f32 registers a thread may give to the pending growth sums
# output tiles (th, tw) tried in order; the first whose feature buffer fits is used. bf16:
# 16 x 16 at gc=16, 8 x 16 at gc=32, 8 x 8 at gc=48. At gc=32, 12 x 12 fits too and recomputes
# less halo (~1.47x against ~1.53x), but its 144 pixels make three 64-row M-blocks for conv5's two
# warpgroups and 25 growth M-tiles for 8 warps, where 8 x 16 makes two and 24, and it overhangs a
# 32 x 32 image: on an H100 B1 and B2 ran 12-28% slower at 12 x 12 than at 8 x 16, and A no faster
# (PERF.md). 4 x 8 only where nothing larger fits: nf=112
# and 128 at gc=48
_TILES = {
    torch.bfloat16: ((16, 16), (8, 16), (8, 8), (4, 8)),
    torch.float32: ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2)),
}


def rdb_reference(x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain RDB forward in x's dtype; the same semantics as the kernel."""

    feats = [x]
    for k in range(4):
        feats.append(F.leaky_relu(_conv3(torch.cat(feats, dim=1), weights[k]), 0.2))
    out = _conv3(torch.cat(feats, dim=1), weights[4]) * 0.2 + x
    if x0 is not None:
        out = out * 0.2 + x0
    return out


def _conv3(v: torch.Tensor, wb) -> torch.Tensor:
    """A 3x3 conv of the block in v's dtype (no bias where it is None)."""
    return F.conv2d(v, wb[0].to(v.dtype), None if wb[1] is None else wb[1].to(v.dtype), padding=1)


class PackedWeights(NamedTuple):
    """The five convs' weights packed for the kernel of one dtype, back to
    back, and the biases ``[b1..b4, b5]`` in float32 (zeros for a bias of None).

    - float32: tap-major per conv, ``[3*ky + kx][cin][cout]`` (HWIO).
    - bfloat16: the chain engine's order (:func:`chain_index`): B fragments
      of the tensor cores, input-channel group outermost, so the kernel
      streams each conv through its shared-memory ring in chunks.
    """

    w: torch.Tensor
    b: torch.Tensor
    nf: int
    gc: int
    dtype: torch.dtype


@functools.lru_cache(maxsize=64)
def _fragment_index_on(cout: int, k: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fragment_index` kept on ``device``: training repacks every RDB's
    weights at every step, and building and uploading the indices each time
    costs more host time than the gather."""
    n_idx, k_idx = fragment_index(cout, k)
    return n_idx.to(device), k_idx.to(device)


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


def chain_index(cout: int, cin: int, last: bool = False) -> torch.Tensor:
    """Flat indices into one conv's (cout, 9*cin) weight matrix (k = tap*cin +
    ci) in the order the bf16 chain engine (``csrc/rdb_common.cuh``
    ``conv_chain``) streams it: k-step (input-channel group c, tap) after
    k-step, c outermost, so a ring slot holds whole groups with all their
    taps. Each k-step holds the 16 k = tap*cin + 16c .. + 15 of all cout
    outputs:

    - a growth conv (mma.sync): [cout/16][32 lanes][4 words][2 halves], in
      :func:`fragment_index`'s B-fragment order;
    - the ``last`` conv (wgmma's K-major B tile, no swizzle):
      [cout/8][2 k halves][8 outputs][8 k], 8 x 8 core matrices of 128 bytes
      (one pass of :func:`last_passes`: the chain packs each pass's rows so).
    """
    if last:
        c, tap, nb, kh, nr, kr = (torch.arange(s).view([-1 if i == d else 1 for i in range(6)])
                                  for d, s in enumerate((cin // 16, 9, cout // 8, 2, 8, 8)))
        return ((8 * nb + nr) * (9 * cin) + tap * cin + 16 * c + 8 * kh + kr).reshape(-1)
    n_idx, k_idx = fragment_index(cout, 9 * cin)
    flat = (n_idx * (9 * cin) + k_idx).view(cout // 16, 9, cin // 16, 32, 4, 2)
    return flat.permute(2, 1, 0, 3, 4, 5).reshape(-1)


def growth_depth(gc: int) -> int:
    """How many growth convs one read of a buffer slice feeds in the bf16
    chain (``csrc/rdb_common.cuh``, the kernels' ``kDepth``): the largest of 4,
    2 and 1 whose k-step, depth x gc outputs, fits a ring slot's 64 columns,
    and whose pending sums, depth x gc / 2 f32 registers a thread for each of
    the M-tiles a warp holds (``_GROWTH_MT``: region 0 of the largest tile
    whose buffer fits at that gc), fit in 96. 2 at gc=16 (depth 4 would hold
    160 registers of sums; it spilled on an H100 and ran no faster), 2 at
    gc=32, 1 at gc=48 (the per-conv step: two convs' 96 outputs overflow a
    slot). The tile the wrapper picks (:func:`_tile`) never holds more
    M-tiles than that largest one, so the depth depends on gc alone."""
    for depth in (4, 2):
        if depth * gc <= _SLOT_COLS and depth * (gc // 2) * _GROWTH_MT[gc] <= _PENDING_REGS:
            return depth
    return 1


def growth_steps(nf: int, gc: int, depth: int) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """The bf16 chain's four growth steps at ``depth``: (first channel,
    channels, convs fed) each. The growth convs run in groups of ``depth``
    (convs a .. a + depth - 1); step c multiplies a part of the buffer ``[x,
    h_1 .. h_4]`` into every conv of its group from c on: at a group's first
    step channels [0, nf + c*gc) (x and every slice an earlier group
    finished), at the others h_c's gc channels. After step c conv c is
    complete. Depth 1 is conv c over all its inputs."""
    steps = []
    for c in range(4):
        a = c // depth * depth
        first, count = (0, nf + c * gc) if c == a else (nf + (c - 1) * gc, gc)
        steps.append((first, count, tuple(range(c, a + depth))))
    return steps


def last_passes(nf: int) -> List[Tuple[int, int]]:
    """The bf16 chain's passes over the last conv's outputs, (first output,
    outputs) each: at most 64 a pass (wgmma's N), so one pass of nf at nf <= 64
    and (0, 64), (64, nf - 64) above. Each pass streams all its k-steps before
    the next, so the packing holds the passes' rows one after the other."""
    return [(n0, min(_LAST_PASS, nf - n0)) for n0 in range(0, nf, _LAST_PASS)]


def _conv_shapes(nf: int, gc: int) -> List[Tuple[int, int, int, int]]:
    return [(gc if k < 4 else nf, nf + k * gc, 3, 3) for k in range(5)]


@functools.lru_cache(maxsize=16)
def _chain_gather(nf: int, gc: int, depth: int, transposed: bool, device: torch.device) -> torch.Tensor:
    """One index into the five forward OIHW weights, flattened and
    concatenated, that gives the bf16 chain's packing at growth ``depth`` in a
    single gather: of the forward chain, or (``transposed``) of
    :func:`transposed_chain` (kernel B2's input-gradient chain). Each growth
    step of :func:`growth_steps` packs the rows of the convs it feeds, one
    conv's gc after the other, over its channels, as one matrix in
    :func:`chain_index`'s order; then the last conv's passes. Kept on ``device``."""
    shapes = _conv_shapes(nf, gc)
    sizes = [math.prod(s) for s in shapes]
    convs = [(part.view(s), None) for part, s in zip(torch.split(torch.arange(sum(sizes)), sizes), shapes)]
    if transposed:
        convs = transposed_chain(convs)
    parts = []
    for first, count, fed in growth_steps(nf, gc, depth):
        wt = torch.cat([convs[c][0][:, first:first + count] for c in fed])
        parts.append(wt.permute(0, 2, 3, 1).reshape(-1)[chain_index(wt.shape[0], count)])
    wt = convs[4][0]
    for n0, n in last_passes(nf):
        parts.append(wt[n0:n0 + n].permute(0, 2, 3, 1).reshape(-1)[chain_index(n, wt.shape[1], last=True)])
    return torch.cat(parts).to(device)


def _chain_depth(nf: int, gc: int) -> int:
    """The bf16 chain's growth depth at these widths (:func:`_tile` raises for widths the chain does not take)."""
    _tile(nf, gc, torch.bfloat16)
    return growth_depth(gc)


def _pack_chain(weights: Weights, transposed: bool) -> torch.Tensor:
    """The bf16 chain packing of the five (OIHW weight, bias) pairs' weights, on their device."""
    gc, nf = weights[0][0].shape[0], weights[4][0].shape[0]
    flat = torch.cat([wt.detach().reshape(-1) for wt, _ in weights]).to(torch.bfloat16)
    return flat[_chain_gather(nf, gc, _chain_depth(nf, gc), transposed, flat.device)]


def _widths(weights: Weights) -> Tuple[int, int]:
    """(nf, gc) of an RDB's five (OIHW weight, bias) pairs; raises on any other shape."""
    if len(weights) != 5:
        raise ValueError(f"an RDB has five convs, got {len(weights)}")
    gc, nf = weights[0][0].shape[0], weights[4][0].shape[0]
    for k, (wt, bs) in enumerate(weights):
        want = _conv_shapes(nf, gc)[k]
        if tuple(wt.shape) != want or (bs is not None and tuple(bs.shape) != want[:1]):
            got = None if bs is None else tuple(bs.shape)
            raise ValueError(f"conv{k + 1}: weight {tuple(wt.shape)} / bias {got}, expected {want}")
    return nf, gc


def pack_rdb_weights(weights: Weights, dtype: torch.dtype = torch.float32) -> PackedWeights:
    """Pack the (OIHW weight, bias) pairs for the kernel of ``dtype``, on their device."""
    nf, gc = _widths(weights)
    b = torch.cat([torch.zeros(wt.shape[0], dtype=torch.float32, device=wt.device) if bs is None
                   else bs.detach().float().reshape(-1) for wt, bs in weights]).contiguous()
    if dtype == torch.float32:
        w = torch.cat([wt.detach().float().permute(2, 3, 1, 0).reshape(-1) for wt, _ in weights])
    elif dtype == torch.bfloat16:
        if nf % 16 or gc % 16:
            raise ValueError(f"the bf16 kernel needs nf and gc divisible by 16, got nf={nf}, gc={gc}")
        w = _pack_chain(weights, transposed=False)
    else:
        raise TypeError(f"the RDB kernel takes float32 or bfloat16, got {dtype}")
    return PackedWeights(w.contiguous(), b, nf, gc, dtype)


def _tile(nf: int, gc: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The first tile of ``_TILES[dtype]`` whose feature buffer fits a block's
    shared memory (bf16: beside the weight ring, ``chain_smem``; and within
    the chain's M-tile limits), or ValueError naming (nf, gc). The bf16 chain
    (``chain_fits``) takes nf a multiple of 16 from 16 to 128 and gc a
    multiple of 16 from 16 to 48."""
    widths_ok = nf % 16 == 0 and 16 <= nf <= _CHAIN_MAX_NF and gc % 16 == 0 and 16 <= gc <= _CHAIN_MAX_GC
    if dtype == torch.bfloat16 and not widths_ok:
        raise ValueError(f"nf={nf}, gc={gc} does not fit the bf16 RDB chain: it takes nf a multiple of 16 from 16 "
                         f"to {_CHAIN_MAX_NF} and gc a multiple of 16 from 16 to {_CHAIN_MAX_GC}")
    for th, tw in _TILES[dtype]:
        ph, pw = th + 2 * _HALO, tw + 2 * _HALO
        if dtype == torch.bfloat16:
            smem = ph * pw * (nf + 4 * gc + _PAD) * 2 + _RING_BYTES
            if (ph - 2) * (pw - 2) > 16 * 8 * _GROWTH_MT[gc] or th * tw > 16 * _LAST_MTILES:
                continue
        else:
            smem = (nf + 4 * gc) * ph * pw * 4
        if smem <= _SMEM_LIMIT:
            return th, tw
    raise ValueError(f"nf={nf}, gc={gc}: the feature buffer does not fit in shared memory at any tile")


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_rdb", _SOURCES)
    lib.climsr_rdb_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.climsr_rdb_fwd_save.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.climsr_rdb_fwd.restype = lib.climsr_rdb_fwd_save.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_rdb_bwd", _BWD_SOURCES)
    lib.climsr_rdb_bwd.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.climsr_rdb_bwd.restype = ctypes.c_int
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
    if x.dtype == torch.bfloat16:
        _tile(packed.nf, packed.gc, x.dtype)  # raises for widths the chain does not take
    if packed.nf % 8 or packed.gc % 8:
        raise ValueError(f"fused_rdb kernel needs nf and gc divisible by 8, got nf={packed.nf}, gc={packed.gc}")
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_rdb(
    x: torch.Tensor,
    weights: Weights,
    x0: Optional[torch.Tensor] = None,
    packed: Optional[PackedWeights] = None,
) -> torch.Tensor:
    """One RDB forward (``x0 + 0.2 * rdb(x)`` when ``x0`` is given).

    ``x``/``x0``: (N, nf, H, W). Where autograd needs a gradient of any input
    this is :class:`FusedRDB` (kernels B1 and B2 on the card). Otherwise, on a
    CUDA tensor it launches kernel A on the current stream (``packed`` saves
    re-packing the weights on every call); it never falls back. On a CPU
    tensor it runs :func:`rdb_reference`.
    """
    if _needs_grad(x, x0, *(t for wb in weights for t in wb)):
        return FusedRDB.apply(x, x0, packed, *(t for wb in weights for t in wb))
    if x.device.type == "cpu":
        return rdb_reference(x, weights, x0)
    return _launch_forward(x, weights, x0, packed, save=False, counter=fused_rdb)[0]


fused_rdb.launches = 0  # kernel A launches since the count was last reset
fused_rdb.source_major = 0  # of them, those whose growth convs ran source-major (bf16 at gc=16, 32)


def _launch_forward(x, weights, x0, packed, save: bool, counter) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel A (``save=False``) or B1 on the current stream; returns (out,
    feat or None) and adds one to ``counter.launches``, the entry point's count."""
    if x.device.type != "cuda":
        raise ValueError(f"the RDB kernels run on CUDA tensors, got {x.device}")
    if packed is None:
        packed = pack_rdb_weights(weights, x.dtype)
    _check(x, x0, packed)
    n, nf, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    total = packed.nf + 4 * packed.gc
    feat = torch.empty((n, total, h, w), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last) if save else None
    if out.numel() == 0:
        return out, feat
    th, tw = _tile(packed.nf, packed.gc, x.dtype)
    bf16 = x.dtype == torch.bfloat16
    depth = growth_depth(packed.gc) if bf16 else 1
    lib = _library()
    args = (n, h, w, packed.nf, packed.gc, th, tw, depth, int(bf16))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        x0_ptr = None if x0 is None else x0.data_ptr()
        if save:
            err = lib.climsr_rdb_fwd_save(x.data_ptr(), x0_ptr, out.data_ptr(), feat.data_ptr(),
                                          packed.w.data_ptr(), packed.b.data_ptr(), *args, stream)
        else:
            err = lib.climsr_rdb_fwd(x.data_ptr(), x0_ptr, out.data_ptr(), packed.w.data_ptr(),
                                     packed.b.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: CUDA error {err}")
    counter.launches += 1
    if depth > 1:
        _count_source_major(counter, "B1" if save else "A")
    return out, feat


def _count_source_major(counter, kernel: str) -> None:
    """One launch whose chain took the source-major growth step (depth > 1):
    in ``counter.source_major`` and the recorder's ``climsr.rdb.source_major.<kernel>``."""
    counter.source_major += 1
    profiling.count(f"climsr.rdb.source_major.{kernel}")


# ---------------------------------------------------------------------------
# Training: kernel B1 (forward that saves feat), kernel B2 (backward), autograd


def rdb_fwd_save_reference(
    x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward that also returns ``feat = [x, h_1 .. h_4]`` in x's dtype."""
    feats = [x]
    for k in range(4):
        feats.append(F.leaky_relu(_conv3(torch.cat(feats, dim=1), weights[k]), 0.2))
    feat = torch.cat(feats, dim=1)
    out = _conv3(feat, weights[4]) * 0.2 + x
    if x0 is not None:
        out = out * 0.2 + x0
    return out, feat.contiguous(memory_format=torch.channels_last)


def rdb_bwd_reference(
    feat: torch.Tensor, g: torch.Tensor, weights: Weights, gy_scale: float, gx_scale: float
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain backward of one RDB from its saved ``feat``, in explicit conv
    algebra, with the TPU kernel's types (``rdb.py:432-500``): the weights in
    g's dtype, every product summed in f32 (in f64 for f64 inputs: an exact
    version to hold the f32 kernel's pixel-wide dW sums against), the
    pre-activation gradients ``dz`` rounded to g's dtype before each conv
    reads them, slopes from sign(h_k). Returns ``(dx, [dW_1 .. dW_5], [db_1
    .. db_5])``; dx in g's dtype, the rest f32 (f64) (OIHW weights); db_k is
    None where conv k has no bias."""
    dt = g.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    nf, gc = g.shape[1], weights[0][0].shape[0]
    f = feat.to(acc)
    ws = [wt.detach().to(dt).to(acc) for wt, _ in weights]
    grad_in, grad_w = torch.nn.grad.conv2d_input, torch.nn.grad.conv2d_weight
    dws: List[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    dbs: List[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    dz = (g.to(acc) * gy_scale).to(dt).to(acc)
    dfeat = grad_in(f.shape, ws[4], dz, padding=1)
    dws[4] = grad_w(f, ws[4].shape, dz, padding=1)
    if weights[4][1] is not None:
        dbs[4] = gy_scale * g.to(acc).sum((0, 2, 3))
    for k in (3, 2, 1, 0):
        lo = nf + k * gc  # h_{k+1}'s channels; also conv k+1's cin
        da = dfeat[:, lo:lo + gc] * torch.where(f[:, lo:lo + gc] > 0, 1.0, 0.2)
        if weights[k][1] is not None:
            dbs[k] = da.sum((0, 2, 3))
        dz = da.to(dt).to(acc)
        dfeat[:, :lo] += grad_in((f.shape[0], lo) + tuple(f.shape[2:]), ws[k], dz, padding=1)
        dws[k] = grad_w(f[:, :lo], ws[k].shape, dz, padding=1)
    dx = (g.to(acc) * gx_scale + dfeat[:, :nf]).to(dt)
    return dx, dws, dbs


def fused_rdb_fwd_save(
    x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None, packed: Optional[PackedWeights] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: the RDB forward and its ``feat`` (N, nf + 4*gc, H, W,
    channels_last). On a CUDA tensor it launches the kernel or raises; on a
    CPU tensor it runs :func:`rdb_fwd_save_reference`."""
    if x.device.type == "cpu":
        return rdb_fwd_save_reference(x, weights, x0)
    return _launch_forward(x, weights, x0, packed, save=True, counter=fused_rdb_fwd_save)


fused_rdb_fwd_save.launches = 0  # kernel B1 launches since the count was last reset
fused_rdb_fwd_save.source_major = 0  # of them, those whose growth convs ran source-major


def transposed_chain(weights: Weights) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The weights of the backward's input-gradient chain, in the forward's conv shapes.

    Kernel B2 runs the input gradient as a forward chain over the buffer
    ``[dz_5, dz_4, dz_3, dz_2, dz_1]``: step s (s = 0..3) computes dfeat of
    h_{4-s} from ``[dz_5, dz_4 .. dz_{5-s}]`` and the last step dfeat of x from
    all of it. Each step's weight is the transposed, spatially flipped slice of
    the forward convs that read that channel group, so the shapes are the
    forward's: (gc, nf + s*gc, 3, 3) and then (nf, nf + 4*gc, 3, 3). Biases are zero.
    """
    ws = [wt for wt, _ in weights]
    gc, nf = ws[0].shape[0], ws[4].shape[0]
    chain = []
    for s in range(4):
        lo = nf + (3 - s) * gc  # h_{4-s}'s channels in feat
        rows = [ws[4][:, lo:lo + gc]] + [ws[j][:, lo:lo + gc] for j in range(3, 3 - s, -1)]
        chain.append((torch.cat(rows, 0).transpose(0, 1).flip(2, 3), ws[0].new_zeros(gc)))
    rows = [ws[4][:, :nf]] + [ws[j][:, :nf] for j in (3, 2, 1, 0)]
    chain.append((torch.cat(rows, 0).transpose(0, 1).flip(2, 3), ws[0].new_zeros(nf)))
    return chain


def _wgrad_jobs(nf: int, gc: int) -> List[Tuple[int, int, int, int, int, int, int]]:
    """The job rows of :func:`wgrad_plan`."""
    total = nf + 4 * gc
    woff = [0]
    for cout, cin, kh, kw in _conv_shapes(nf, gc):
        woff.append(woff[-1] + cout * cin * kh * kw)
    jobs = []
    for zc in range(0, total, 16):
        j, co0 = (4, zc) if zc < nf else (3 - (zc - nf) // gc, (zc - nf) % gc)
        cin = nf + j * gc
        groups, parts = cin // 16, -(-cin // _WGRAD_MAX_CIN)  # input groups of 16, cut in near-equal parts
        for p in range(parts):
            g0, g1 = p * groups // parts, (p + 1) * groups // parts
            jobs.append((zc, j, co0, cin, woff[j], 16 * g0, 16 * (g1 - g0)))
    return jobs


def wgrad_plan(n: int, h: int, w: int, nf: int, gc: int, splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which block of kernel B2's bf16 dW pass computes what: ``(jobs, bounds)``, int32.

    ``jobs`` has a row per 16-channel group of ``z = [dz_5, dz_4 .. dz_1]`` and
    part of its conv's input channels (at most 128 a part, near-equal parts:
    one at gc=16, where every cin <= 128; conv5's 192 and conv4's 160 in two
    halves each at gc=32): (its first channel in z, the conv j (0-based) whose
    output gradient it is, its first output channel in conv j, conv j's cin,
    conv j's first weight in the flat ``[dW_1 .. dW_5]``, the part's first
    input channel ci0, its input channels cic). ``bounds`` (``splits + 1``)
    splits the pixel tiles: split s takes tiles ``bounds[s] .. bounds[s + 1] -
    1``, tile t being 8 x 16 pixels of image ``t // (ty * tx)`` at rows ``8 *
    ((t // tx) % ty)``, columns ``16 * (t % tx)``, with ty, tx the tiles per
    column and row. Block b takes job ``b % len(jobs)`` over split ``b //
    len(jobs)``: rows co0 .. co0 + 15 and inputs ci0 .. ci0 + cic - 1 of dW_j,
    every tap, into that split's partial, and, if ci0 is 0 and conv j is a
    growth conv, db_j at those rows.
    """
    th, tw = _WGRAD_TILE
    tiles = n * -(-h // th) * -(-w // tw)
    bounds = [s * tiles // splits for s in range(splits + 1)]
    return (torch.tensor(_wgrad_jobs(nf, gc), dtype=torch.int32),
            torch.tensor(bounds, dtype=torch.int32))


@functools.lru_cache(maxsize=64)
def _wgrad_plan_on(n: int, h: int, w: int, nf: int, gc: int, splits: int, device: torch.device):
    """:func:`wgrad_plan` kept on ``device``: one upload per shape, not per call."""
    return tuple(t.to(device) for t in wgrad_plan(n, h, w, nf, gc, splits))


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_bwd(feat: torch.Tensor, g: torch.Tensor, packed: PackedWeights) -> None:
    _check(g, None, packed)
    total = packed.nf + 4 * packed.gc
    if packed.nf % 16 or packed.gc % 16:
        raise ValueError(f"fused_rdb_bwd kernel needs nf and gc divisible by 16, got nf={packed.nf}, gc={packed.gc}")
    want = (g.shape[0], total) + tuple(g.shape[2:])
    if tuple(feat.shape) != want or feat.dtype != g.dtype or feat.device != g.device:
        raise ValueError(f"feat must be {want} in g's dtype and device, got {tuple(feat.shape)} {feat.dtype}")
    if not feat.is_contiguous(memory_format=torch.channels_last) or feat.data_ptr() % 16:
        raise ValueError("fused_rdb_bwd kernel needs feat channels_last and 16-byte aligned")


def fused_rdb_bwd(
    feat: torch.Tensor, g: torch.Tensor, weights: Weights, gy_scale: float, gx_scale: float
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Kernel B2: ``(dx, [dW_1 .. dW_5], [db_1 .. db_5])`` of one RDB, as
    :func:`rdb_bwd_reference` returns them. ``weights`` are in g's dtype. On a
    CUDA tensor it launches the kernel (three launches on the current stream,
    counted as one) or raises; on a CPU tensor it runs the plain version. db_5
    is ``gy * sum(g)`` in f32 outside the kernel, as in ``rdb.py:566``; db_k
    is None, and that sum is skipped, where conv k has no bias (the kernel
    still writes the growth convs' sums, which are dropped)."""
    if g.device.type == "cpu":
        return rdb_bwd_reference(feat, g, weights, gy_scale, gx_scale)
    if g.device.type != "cuda":
        raise ValueError(f"the RDB kernels run on CUDA tensors, got {g.device}")
    bf16 = g.dtype == torch.bfloat16
    nf, gc = _widths(weights)
    if bf16:  # one gather from the forward weights, no transposed copies; the chain has no biases
        no_bias = torch.empty(0, dtype=torch.float32, device=g.device)
        packed = PackedWeights(_pack_chain(weights, transposed=True), no_bias, nf, gc, g.dtype)
    else:
        packed = pack_rdb_weights(transposed_chain(weights), g.dtype)
    _check_bwd(feat, g, packed)
    n, nf, h, w = g.shape
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    z = torch.empty_like(feat, memory_format=torch.channels_last)
    sizes = [math.prod(s) for s in _conv_shapes(nf, gc)]
    tiles = n * -(-h // _WGRAD_TILE[0]) * -(-w // _WGRAD_TILE[1])
    if bf16:  # two blocks per SM: jobs x splits
        splits = max(1, min(tiles, 2 * _sm_count(g.device) // len(_wgrad_jobs(nf, gc))))
        jobs, bounds = _wgrad_plan_on(n, h, w, nf, gc, splits, g.device)
        plan = (jobs.data_ptr(), bounds.data_ptr(), jobs.shape[0])
    else:
        splits = max(1, min(_MAX_SPLITS, tiles))
        plan = (None, None, 0)
    f32 = dict(dtype=torch.float32, device=g.device)
    partial = torch.empty(splits * sum(sizes), **f32)
    db_partial = torch.empty(splits * 4 * gc, **f32)
    dw = torch.empty(sum(sizes), **f32)
    db = torch.empty(4 * gc, **f32)
    th, tw = _tile(nf, gc, g.dtype)
    depth = growth_depth(gc) if bf16 else 1
    lib = _bwd_library()
    with torch.cuda.device(g.device):
        err = lib.climsr_rdb_bwd(
            feat.data_ptr(), g.data_ptr(), packed.w.data_ptr(), dx.data_ptr(), z.data_ptr(), partial.data_ptr(),
            db_partial.data_ptr(), dw.data_ptr(), db.data_ptr(), *plan, n, h, w, nf, gc, th, tw, depth, splits,
            float(gy_scale), float(gx_scale), int(bf16), torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rdb_bwd kernel launch failed: CUDA error {err}")
    fused_rdb_bwd.launches += 1
    if depth > 1:
        _count_source_major(fused_rdb_bwd, "B2")
    dws = [part.view(wt.shape) for part, (wt, _) in zip(torch.split(dw, sizes), weights)]
    db5 = None if weights[4][1] is None else gy_scale * g.sum((0, 2, 3), dtype=torch.float32)
    dbs = [part if bs is not None else None for part, (_, bs) in zip(list(torch.split(db, gc)) + [db5], weights)]
    return dx, dws, dbs


fused_rdb_bwd.launches = 0  # kernel B2 calls since the count was last reset
fused_rdb_bwd.source_major = 0  # of them, those whose dX pass's growth steps ran source-major


class FusedRDB(torch.autograd.Function):
    """One RDB with its gradient: the counterpart of ``fused_rdb_t`` /
    ``fused_rdb_res_t`` and their ``custom_vjp`` (``rdb.py:570-612``).

    ``apply(x, x0, packed, w1, b1, ..., w5, b5)``: the raw parameters (any
    float dtype) are inputs, so autograd routes dW and db to them; the block
    computes in x's dtype (the parameters are rounded to it at use, as flax
    casts ``kernel.astype(dtype)``), and the parameter gradients come back
    rounded to x's dtype and then in the parameters' own, as JAX's do through
    that cast. A bias may be None (a bias-free conv: no gradient for it).
    ``packed`` (or None) is the forward weights' packing for x's
    dtype. Forward: :func:`fused_rdb_fwd_save`; backward:
    :func:`fused_rdb_bwd` with scales (0.2, 1), or (0.04, 0.2) and dx0 = g
    when the enclosing residual x0 is folded in.
    """

    @staticmethod
    def forward(ctx, x, x0, packed, *params):
        weights = list(zip(params[0::2], params[1::2]))
        out, feat = fused_rdb_fwd_save(x, weights, x0, packed)
        ctx.with_x0 = x0 is not None
        ctx.save_for_backward(feat, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, *params = ctx.saved_tensors
        dt = feat.dtype
        g = g.to(dt).contiguous(memory_format=torch.channels_last)
        weights = [(w.to(dt), None if b is None else b.to(dt)) for w, b in zip(params[0::2], params[1::2])]
        gy, gx = (0.04, 0.2) if ctx.with_x0 else (0.2, 1.0)
        dx, dws, dbs = fused_rdb_bwd(feat, g, weights, gy, gx)
        grads = []
        for k, (w, b) in enumerate(zip(params[0::2], params[1::2])):
            grads += [dws[k].to(dt).to(w.dtype), None if b is None else dbs[k].to(dt).to(b.dtype)]
        return (dx, g if ctx.with_x0 else None, None, *grads)


# ---------------------------------------------------------------------------
# Kernel D: the NHWC entry point (the JAX package's public ``fused_rdb``)


def fused_rdb_nhwc(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    w4: torch.Tensor, b4: torch.Tensor,
    w5: torch.Tensor, b5: torch.Tensor,
    batch_tile: Optional[int] = None,
) -> torch.Tensor:
    """One RDB, ``x + 0.2 * conv5(...)``, with the arguments of the JAX
    package's ``fused_rdb`` (``climsr_tpu/ops/pallas/rdb.py:634``, TPU kernel
    D ``_rdb_kernel`` ``:83``): ``x`` (N, H, W, nf) and HWIO weights
    (3, 3, cin, cout). Returns (N, H, W, nf).

    D and kernel A compute the same function (A without ``x0``); the TPU had
    two kernels only because it had two layouts. An NHWC tensor is the port's
    ``channels_last`` layout, so ``x.permute(0, 3, 1, 2)`` is a free view and
    D's counterpart on the card is kernel A (``csrc/rdb_fwd.cu``), launched
    from here and counted in ``fused_rdb_nhwc.launches``. Where autograd needs
    a gradient the block goes through :class:`FusedRDB` (kernels B1 and B2),
    whose gradient is the one JAX's reference VJP computes
    (``rdb.py:644-646``). On a CPU tensor it runs :func:`rdb_reference`; on a
    CUDA tensor the kernel cannot take it raises.

    ``batch_tile`` is accepted for the JAX signature and ignored: it sets the
    TPU grid's images per step and changes no number; the CUDA grid tiles each
    image by itself.
    """
    del batch_tile
    params = (w1, b1, w2, b2, w3, b3, w4, b4, w5, b5)
    weights = [(params[2 * k].permute(3, 2, 0, 1), params[2 * k + 1]) for k in range(5)]  # OIHW views
    xc = x.contiguous().permute(0, 3, 1, 2)  # NCHW view of NHWC storage: channels_last
    if _needs_grad(x, *params):
        out = FusedRDB.apply(xc, None, None, *(t for wb in weights for t in wb))
    elif x.device.type == "cpu":
        out = rdb_reference(xc, weights)
    else:
        out = _launch_forward(xc, weights, None, None, save=False, counter=fused_rdb_nhwc)[0]
    return out.permute(0, 2, 3, 1)


fused_rdb_nhwc.launches = 0  # kernel A launches through this entry since the count was last reset
fused_rdb_nhwc.source_major = 0  # of them, those whose growth convs ran source-major
