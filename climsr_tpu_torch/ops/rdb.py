# -*- coding: utf-8 -*-
"""Fused residual dense block (RDB): CUDA kernels, their plain versions and autograd.

One RDB is four 3x3 growth convs (cin = nf + k*gc -> gc, bias, LeakyReLU 0.2)
over the growing concatenation ``[x, h_1, ..., h_k]``, then conv5 (nf + 4*gc ->
nf) and the residual ``x + 0.2 * conv5``. With ``x0`` the enclosing RRDB's
residual is folded into the same write: ``x0 + 0.2 * (x + 0.2 * conv5)``.

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
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]  # five (OIHW weight, bias) pairs

_SOURCES = ("rdb_fwd.cu",)  # kernels A and B1
_BWD_SOURCES = ("rdb_bwd.cu",)  # kernel B2
_MAX_SPLITS = 32  # kernel B2's dW partials: at most this many splits of the pixels
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
            n_idx, k_idx = _fragment_index_on(cout, 9 * cin, wk.device)
            parts.append(wk[n_idx, k_idx])
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
    lib.climsr_rdb_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.climsr_rdb_fwd_save.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.climsr_rdb_fwd.restype = lib.climsr_rdb_fwd_save.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_rdb_bwd", _BWD_SOURCES)
    lib.climsr_rdb_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
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
    return _launch_forward(x, weights, x0, packed, save=False)[0]


fused_rdb.launches = 0  # kernel A launches since the count was last reset


def _launch_forward(x, weights, x0, packed, save: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel A (``save=False``) or B1 on the current stream; returns (out, feat or None)."""
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
    lib = _library()
    args = (n, h, w, packed.nf, packed.gc, th, tw, int(x.dtype == torch.bfloat16))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        x0_ptr = None if x0 is None else x0.data_ptr()
        if save:
            err = lib.climsr_rdb_fwd_save(x.data_ptr(), x0_ptr, out.data_ptr(), feat.data_ptr(),
                                          packed.w.data_ptr(), packed.b.data_ptr(), *args, stream)
        else:
            err = lib.climsr_rdb_fwd(x.data_ptr(), x0_ptr, out.data_ptr(), packed.w.data_ptr(),
                                     packed.b.data_ptr(), *args, stream)
    name = "fused_rdb_fwd_save" if save else "fused_rdb"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    (fused_rdb_fwd_save if save else fused_rdb).launches += 1
    return out, feat


# ---------------------------------------------------------------------------
# Training: kernel B1 (forward that saves feat), kernel B2 (backward), autograd


def rdb_fwd_save_reference(
    x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward that also returns ``feat = [x, h_1 .. h_4]`` in x's dtype."""

    def conv(v, wb):
        return F.conv2d(v, wb[0].to(v.dtype), wb[1].to(v.dtype), padding=1)

    feats = [x]
    for k in range(4):
        feats.append(F.leaky_relu(conv(torch.cat(feats, dim=1), weights[k]), 0.2))
    feat = torch.cat(feats, dim=1)
    out = conv(feat, weights[4]) * 0.2 + x
    if x0 is not None:
        out = out * 0.2 + x0
    return out, feat.contiguous(memory_format=torch.channels_last)


def rdb_bwd_reference(
    feat: torch.Tensor, g: torch.Tensor, weights: Weights, gy_scale: float, gx_scale: float
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain backward of one RDB from its saved ``feat``, in explicit conv
    algebra, with the TPU kernel's types (``rdb.py:432-500``): the weights in
    g's dtype, every product summed in f32, the pre-activation gradients
    ``dz`` rounded to g's dtype before each conv reads them, slopes from
    sign(h_k). Returns ``(dx, [dW_1 .. dW_5], [db_1 .. db_5])``; dx in g's
    dtype, the rest f32 (OIHW weights)."""
    dt = g.dtype
    nf, gc = g.shape[1], weights[0][0].shape[0]
    f = feat.float()
    ws = [wt.detach().to(dt).float() for wt, _ in weights]
    grad_in, grad_w = torch.nn.grad.conv2d_input, torch.nn.grad.conv2d_weight
    dws: List[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    dbs: List[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    dz = (g.float() * gy_scale).to(dt).float()
    dfeat = grad_in(f.shape, ws[4], dz, padding=1)
    dws[4] = grad_w(f, ws[4].shape, dz, padding=1)
    dbs[4] = gy_scale * g.float().sum((0, 2, 3))
    for k in (3, 2, 1, 0):
        lo = nf + k * gc  # h_{k+1}'s channels; also conv k+1's cin
        da = dfeat[:, lo:lo + gc] * torch.where(f[:, lo:lo + gc] > 0, 1.0, 0.2)
        dbs[k] = da.sum((0, 2, 3))
        dz = da.to(dt).float()
        dfeat[:, :lo] += grad_in((f.shape[0], lo) + tuple(f.shape[2:]), ws[k], dz, padding=1)
        dws[k] = grad_w(f[:, :lo], ws[k].shape, dz, padding=1)
    dx = (g.float() * gx_scale + dfeat[:, :nf]).to(dt)
    return dx, dws, dbs


def fused_rdb_fwd_save(
    x: torch.Tensor, weights: Weights, x0: Optional[torch.Tensor] = None, packed: Optional[PackedWeights] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: the RDB forward and its ``feat`` (N, nf + 4*gc, H, W,
    channels_last). On a CUDA tensor it launches the kernel or raises; on a
    CPU tensor it runs :func:`rdb_fwd_save_reference`."""
    if x.device.type == "cpu":
        return rdb_fwd_save_reference(x, weights, x0)
    return _launch_forward(x, weights, x0, packed, save=True)


fused_rdb_fwd_save.launches = 0  # kernel B1 launches since the count was last reset


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


def _check_bwd(feat: torch.Tensor, g: torch.Tensor, packed: PackedWeights) -> None:
    _check(g, None, packed)
    total = packed.nf + 4 * packed.gc
    if packed.nf % 16 or packed.gc % 16 or total > 128:
        raise ValueError(f"fused_rdb_bwd kernel needs nf and gc divisible by 16 and nf + 4*gc <= 128, "
                         f"got nf={packed.nf}, gc={packed.gc}")
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
    is ``gy * sum(g)`` in f32 outside the kernel, as in ``rdb.py:566``."""
    if g.device.type == "cpu":
        return rdb_bwd_reference(feat, g, weights, gy_scale, gx_scale)
    if g.device.type != "cuda":
        raise ValueError(f"the RDB kernels run on CUDA tensors, got {g.device}")
    packed = pack_rdb_weights(transposed_chain(weights), g.dtype)
    _check_bwd(feat, g, packed)
    n, nf, h, w = g.shape
    gc = packed.gc
    total = nf + 4 * gc
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    z = torch.empty_like(feat, memory_format=torch.channels_last)
    sizes = [(gc if k < 4 else nf) * (nf + k * gc) * 9 for k in range(5)]
    splits = max(1, min(_MAX_SPLITS, n * -(-h // 8) * -(-w // 16)))
    f32 = dict(dtype=torch.float32, device=g.device)
    partial = torch.empty(splits * sum(sizes), **f32)
    db_partial = torch.empty(splits * 4 * gc, **f32)
    dw = torch.empty(sum(sizes), **f32)
    db = torch.empty(4 * gc, **f32)
    th, tw = _tile(nf, gc, g.dtype)
    lib = _bwd_library()
    with torch.cuda.device(g.device):
        err = lib.climsr_rdb_bwd(
            feat.data_ptr(), g.data_ptr(), packed.w.data_ptr(), dx.data_ptr(), z.data_ptr(), partial.data_ptr(),
            db_partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n, h, w, nf, gc, th, tw, splits,
            float(gy_scale), float(gx_scale), int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rdb_bwd kernel launch failed: CUDA error {err}")
    fused_rdb_bwd.launches += 1
    dws = [part.view(wt.shape) for part, (wt, _) in zip(torch.split(dw, sizes), weights)]
    dbs = list(torch.split(db, gc)) + [gy_scale * g.float().sum((0, 2, 3))]
    return dx, dws, dbs


fused_rdb_bwd.launches = 0  # kernel B2 calls since the count was last reset


class FusedRDB(torch.autograd.Function):
    """One RDB with its gradient: the counterpart of ``fused_rdb_t`` /
    ``fused_rdb_res_t`` and their ``custom_vjp`` (``rdb.py:570-612``).

    ``apply(x, x0, packed, w1, b1, ..., w5, b5)``: the raw parameters (any
    float dtype) are inputs, so autograd routes dW and db to them; the block
    computes in x's dtype (the parameters are rounded to it at use, as flax
    casts ``kernel.astype(dtype)``), and the parameter gradients come back
    rounded to x's dtype and then in the parameters' own, as JAX's do through
    that cast. ``packed`` (or None) is the forward weights' packing for x's
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
        weights = [(params[2 * k].to(dt), params[2 * k + 1].to(dt)) for k in range(5)]
        gy, gx = (0.04, 0.2) if ctx.with_x0 else (0.2, 1.0)
        dx, dws, dbs = fused_rdb_bwd(feat, g, weights, gy, gx)
        grads = []
        for k in range(5):
            grads += [dws[k].to(dt).to(params[2 * k].dtype), dbs[k].to(dt).to(params[2 * k + 1].dtype)]
        return (dx, g if ctx.with_x0 else None, None, *grads)
