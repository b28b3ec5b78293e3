# -*- coding: utf-8 -*-
"""Spatially sharded convolution through a halo exchange: the port of
``climsr_tpu.parallel.halo``.

A frame's H axis is split over a mesh axis; each rank holds its H-slice
(NCHW, H is dim 2) and receives ``halo`` boundary rows from each neighbour.
The JAX package gets the exchange from ``lax.ppermute`` inside ``shard_map``
and its gradient as the transposed ``ppermute``; here :class:`_Exchange` is an
``autograd.Function`` whose backward is the reverse exchange. Both directions
all-gather every rank's edge rows (a collective that NCCL and gloo take for
CUDA tensors) and keep the neighbours'.

- :func:`halo_exchange_pad` (zeros at the frame edges) and
  :func:`_halo_pad_reflect` (reflection at the frame edges);
- :func:`sharded_conv2d`: an exact 'same' conv over the local slice;
- :func:`spatial_sharded_apply` / :func:`spatial_sharded_apply_multi`: a
  whole-frame function run on the local slice plus ``halo`` rows (times each
  input's scale), its output cropped back to the slice;
- :func:`spatial_sharded_model_forward`: the differentiable H-sharded
  generator forward for spatial-shard training, over whole frames, and
  :func:`gather_rows`, which reassembles its output for the spatial GAN step.

Every function here works on the rank's own tensors: the caller hands each
rank its slice (or, for the model forward, the whole frames) and gets back the
rank's rows of the output.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from climsr_tpu_torch.parallel.mesh import all_gather_dim, axis_info


def _neighbours_of(stacked: torch.Tensor, rank: int, size: int, halo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """From every rank's [first | last] ``halo`` rows, stacked on dim 0: the
    last rows of rank-1 and the first rows of rank+1 (the ring wraps)."""
    return stacked[(rank - 1) % size][:, :, halo:], stacked[(rank + 1) % size][:, :, :halo]


class _Exchange(torch.autograd.Function):
    """(rows from rank-1, rows from rank+1) over the ring of the axis; the
    backward sends each cotangent back to the rank its rows came from."""

    @staticmethod
    def forward(ctx, x, halo, group, rank, size):
        ctx.halo, ctx.group, ctx.rank, ctx.size, ctx.shape = halo, group, rank, size, x.shape
        edges = torch.cat([x[:, :, :halo], x[:, :, -halo:]], dim=2)[None]
        return _neighbours_of(all_gather_dim(edges, 0, group, size), rank, size, halo)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        h = ctx.halo
        sent = torch.cat([g_prev, g_next], dim=2)[None]
        stacked = all_gather_dim(sent, 0, ctx.group, ctx.size)
        # my last rows went to rank+1 as its `prev`; my first rows to rank-1 as its `next`
        to_last = stacked[(ctx.rank + 1) % ctx.size][:, :, :h]
        to_first = stacked[(ctx.rank - 1) % ctx.size][:, :, h:]
        gx = torch.zeros(ctx.shape, dtype=g_prev.dtype, device=g_prev.device)
        gx[:, :, :h] += to_first
        gx[:, :, -h:] += to_last
        return gx, None, None, None, None


def _exchange(x: torch.Tensor, halo: int, mesh, axis_name: str):
    group, rank, size = axis_info(mesh, axis_name)
    if x.shape[2] < halo:
        raise ValueError(f"a shard of {x.shape[2]} rows cannot send a halo of {halo}")
    if size == 1:  # the ring of one rank: its own rows, replaced at both edges below
        return x[:, :, -halo:], x[:, :, :halo], 0, 1
    prev, nxt = _Exchange.apply(x, halo, group, rank, size)
    return prev, nxt, rank, size


def halo_exchange_pad(x: torch.Tensor, halo: int, mesh, axis_name: str = "data") -> torch.Tensor:
    """The local H-slice (N, C, Hl, W) with ``halo`` neighbour rows above and
    below; zeros at the frame edges (``climsr_tpu/parallel/halo.py:42``)."""
    if halo <= 0:
        return x
    prev, nxt, rank, size = _exchange(x, halo, mesh, axis_name)
    if rank == 0:
        prev = torch.zeros_like(prev)
    if rank == size - 1:
        nxt = torch.zeros_like(nxt)
    return torch.cat([prev, x, nxt], dim=2)


def _halo_pad_reflect(x: torch.Tensor, halo: int, mesh, axis_name: str = "data") -> torch.Tensor:
    """The local H-slice with ``halo`` neighbour rows, reflected at the frame edges (``:89``)."""
    if halo <= 0:
        return x
    prev, nxt, rank, size = _exchange(x, halo, mesh, axis_name)
    if rank == 0:
        prev = x[:, :, 1: halo + 1].flip(2)
    if rank == size - 1:
        nxt = x[:, :, -halo - 1: -1].flip(2)
    return torch.cat([prev, x, nxt], dim=2)


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, mesh, axis_name: str = "data",
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An exact 'same'-padded conv of the local H-slice (``:66``): the halo
    exchange supplies the rows above and below, W is zero-padded. ``weight``
    is (Cout, Cin, kh, kw) with an odd kh."""
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0:
        raise ValueError(f"sharded_conv2d requires an odd kernel height for 'same' geometry, got {kh}")
    return F.conv2d(halo_exchange_pad(x, kh // 2, mesh, axis_name), weight, bias, padding=(0, kw // 2))


def spatial_sharded_apply(fn: Callable[[torch.Tensor], torch.Tensor], mesh, axis_name: str = "data",
                          halo: int = 32, scale: int = 4) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn`` run on the local H-slice plus ``halo`` rows from each neighbour
    (reflected at the frame edges), its output cropped back to the slice's
    ``Hl * scale`` rows (``:105``): one exchange for the whole function."""
    return spatial_sharded_apply_multi(fn, mesh, axis_name=axis_name, halo=halo, scale=scale)


def spatial_sharded_apply_multi(fn: Callable[..., torch.Tensor], mesh, axis_name: str = "data",
                                halo: int = 32, scale: int = 4,
                                input_scales: tuple = (1,)) -> Callable[..., torch.Tensor]:
    """The multi-input form (``:123``): input ``i``'s H is ``input_scales[i]``
    times the first's (an ESRGAN fusion forward takes LR at 1 and the
    elevation and mask at the HR scale) and gets ``halo * input_scales[i]``
    rows, so the local views stay aligned."""

    def local(*xs: torch.Tensor) -> torch.Tensor:
        padded = [_halo_pad_reflect(x, halo * s, mesh, axis_name) for x, s in zip(xs, input_scales)]
        out = fn(*padded)
        return out[:, :, halo * scale: out.shape[2] - halo * scale]

    return local


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of a frame, concatenated on H; the backward keeps the
    rank's own rows of the (identical) full-frame gradient and sums nothing."""

    @staticmethod
    def forward(ctx, x, rows, group, size, per, total):
        ctx.rows = rows
        padded = F.pad(x, (0, 0, 0, per - x.shape[2]))
        return all_gather_dim(padded.contiguous(), 2, group, size)[:, :, :total]

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.rows].contiguous(), None, None, None, None, None


def gather_rows(x: torch.Tensor, rows: slice, mesh, axis: str, per: int, total: int) -> torch.Tensor:
    """The whole frame of ``total`` rows from each rank's ``x`` (its ``rows``
    of it, at most ``per``) over the mesh axis: the spatial GAN step's ``sr``
    before the discriminator and VGG, which every rank of the axis then runs
    on the same frame."""
    group, _, size = axis_info(mesh, axis)
    if size == 1:
        return x
    return _GatherRows.apply(x, rows, group, size, per, total)


def spatial_sharded_model_forward(model, generator_type: str, mesh, axis: str = "spatial", halo: int = 8,
                                  scale: int = 4):
    """The differentiable H-sharded generator forward (``:162``).

    Returns ``fwd(lr, elevation=None, mask=None) -> (sr_rows, rows)``
    (``fwd.rows_per_rank(h)`` is the most output rows a rank returns). The
    inputs are the rank's whole frames (its batch slice when the mesh has a
    data axis, which the caller takes); the rank runs the generator on its
    H-slice plus ``halo`` rows of each neighbour (reflected at the frame
    edges) and returns its rows of the output, ``sr_rows = sr[:, :, rows]``.
    Heights that do not divide the axis are reflect-padded at the bottom and
    the output is cropped to ``h * out_scale`` rows, so the last rank may
    return fewer rows. Models with a global pool (RCAN's channel attention,
    ``spatial_axis``) are cloned with the axis, the halo and the padding, so
    the pool spans the frame.

    Each rank's loss is its share of the global loss, and the replicated
    parameters' gradients are summed over the ranks (the transpose of a
    replicated input). Not for DDP, which averages, unless the loss is scaled
    to match. Exact, forward and gradient, where ``halo`` covers the
    generator's receptive field; the local slice must keep more rows than the
    halo.
    """
    from climsr_tpu_torch.models import FUSION_GENERATORS, PRE_UPSCALED_GENERATORS

    _, rank, n = axis_info(mesh, axis)
    fusion = generator_type in FUSION_GENERATORS
    out_scale = 1 if generator_type in PRE_UPSCALED_GENERATORS else scale
    in_scales = (1, scale, scale) if fusion else (1,)
    supports_global_pool = hasattr(model, "spatial_axis")

    def fwd(lr: torch.Tensor, elevation: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        h = lr.shape[2]
        pad = (-h) % n
        inputs = (lr, elevation, mask) if fusion else (lr,)
        if pad:
            inputs = tuple(F.pad(x, (0, 0, 0, pad * s), mode="reflect") for x, s in zip(inputs, in_scales))
        hl = (h + pad) // n
        assert hl > halo, (
            f"spatial shard too thin: {h + pad} rows / {n} shards leaves {hl} <= halo={halo}; "
            "lower spatial_halo or the axis size"
        )
        mdl = model.clone(spatial_axis=axis_info(mesh, axis), spatial_halo=halo, spatial_pad=pad) \
            if supports_global_pool else model
        local = [x[:, :, rank * hl * s: (rank + 1) * hl * s] for x, s in zip(inputs, in_scales)]
        padded = [_halo_pad_reflect(x, halo * s, mesh, axis) for x, s in zip(local, in_scales)]
        out = mdl(*padded)
        out = out[:, :, halo * out_scale: out.shape[2] - halo * out_scale]
        r0 = rank * hl * out_scale
        r1 = min((rank + 1) * hl, h) * out_scale
        return out[:, :, : r1 - r0], slice(r0, r1)

    fwd.rows_per_rank = lambda h: -(-h // n) * out_scale
    return fwd
