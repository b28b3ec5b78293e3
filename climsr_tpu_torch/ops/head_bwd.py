# -*- coding: utf-8 -*-
"""The fusion head's 9x9 input gradient to one channel: CUDA kernel C and autograd.

The counterpart of ``climsr_tpu/ops/pallas/head_bwd.py``. ESRGAN's fusion head
is an SRCNN over ``concat(out, elevation, mask)``; in training only channel 0
(the generator's output) needs a gradient, the others are data.

- :func:`conv9_dx_c0_reference` is the plain version (``conv2d_input`` of the
  channel-0 weights), with the TPU kernel's types: g in its own dtype, the
  weights read as f32, f32 sums, output rounded to g's dtype.
- :func:`conv9_dx_c0` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/conv9_dx_c0.cu`` (which replaces the TPU kernel
  ``_dx_c0_kernel``, ``head_bwd.py:53``) or raises; for a CPU tensor it runs
  the plain version. It counts its launches in ``conv9_dx_c0.launches``. In
  bf16 (cout = 64) the kernel runs each output row as a GEMM on the tensor
  cores, P_y[s, dx] = sum over (dy, c) of g[y + dy - 4, s, c] * Wrev[dy, dx,
  c], and then adds P's anti-diagonals, out[y, x] = sum_dx P_y[x + dx - 4,
  dx] (:func:`wrev_matrix` is that B, :func:`pack_wrev` its packing); g is
  read from device memory once, through a ring of staged rows. f32 runs on
  the CUDA cores.
- :class:`FusionConv1` (:func:`fusion_conv1`) is the head's conv1 with that
  backward (``head_bwd.py:124-160``): the forward and dW/db are the library's
  convs, as the JAX package leaves them to XLA; dX is the kernel, exact for
  channel 0 and ZERO for channels 1+. It is valid only where those channels'
  gradients are discarded: ESRGAN turns it on only with one output channel.
- :func:`dc0` is kernel F's entry point (the probe kernels ``_dc0_kernel``
  and ``_dc0_kernel_dyfac`` of ``scripts/bench_head_bwd_probe.py:48,68``):
  C's function with the probe's arguments, ``g`` and the channel-0 taps
  ``w1c0`` (9, 9, C). The TPU had a projection plan for it, in two orders
  ("flat" and "dyfac"); on the card it launches kernel C with the weight view
  :func:`dc0_weight`, as D launches kernel A. ``variant`` is checked and
  counted and selects no other code. Its plain version is
  :func:`dc0_reference`. Only the probe
  (``climsr_tpu_torch.scripts.bench_head_bwd_probe``) runs it; C stays on the
  training path.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib
from climsr_tpu_torch.ops.rdb import _fragment_index_on

_SOURCES = ("conv9_dx_c0.cu",)
_CHUNK = 16  # the f32 kernel walks the output channels 16 at a time
_BF16_COUT = 64  # the bf16 kernel's g channels: the fusion head's conv1 outputs


def conv9_dx_c0_reference(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dX of a SAME 9x9 conv for input channel 0. ``g``: (N, cout, H, W);
    ``weight``: (cout, cin, 9, 9) in the compute dtype. Returns (N, 1, H, W) in g's dtype."""
    n, _, h, w = g.shape
    w0 = weight[:, :1].float()
    return torch.nn.grad.conv2d_input((n, 1, h, w), w0, g.float(), padding=4).to(g.dtype)


def wrev_matrix(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's B as a (16, 9 * cout) matrix: row dx, column k = dy *
    cout + c holds Wrev[dy, dx, c] = W[c, 0, 8 - dy, 8 - dx] for dx < 9; rows
    9-15 (N padded to two mma n-tiles) are zero. In ``weight``'s dtype and device."""
    cout = weight.shape[0]
    wrev = weight[:, 0].flip(1, 2).permute(2, 1, 0).reshape(9, 9 * cout)  # [dx][dy * cout + c]
    return torch.cat([wrev, wrev.new_zeros(7, 9 * cout)])


def pack_wrev(weight: torch.Tensor) -> torch.Tensor:
    """:func:`wrev_matrix` rounded to bf16 in ``mma.m16n8k16`` B-fragment order
    (:func:`~climsr_tpu_torch.ops.rdb.fragment_index`): [36 k-steps][32
    lanes][4 words][2 halves], k-step s = 4 dy + c // 16, one 16-byte vector
    per lane and k-step, the gather index kept on the weight's device."""
    b = wrev_matrix(weight.to(torch.bfloat16))
    n_idx, k_idx = _fragment_index_on(16, b.shape[1], weight.device)
    return b[n_idx, k_idx].contiguous()


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_head_bwd", _SOURCES)
    lib.climsr_conv9_dx_c0.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.climsr_conv9_dx_c0.restype = ctypes.c_int
    return lib


def conv9_dx_c0(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Kernel C: as :func:`conv9_dx_c0_reference`. On a CUDA tensor it launches
    the kernel on the current stream or raises; on a CPU tensor it runs the
    plain version. ``g`` must be channels_last (NHWC storage); in bf16 it must
    have 64 channels and ``weight`` is read rounded to bf16."""
    if g.device.type == "cpu":
        return conv9_dx_c0_reference(g, weight)
    return _launch_conv9(g, weight, counter=conv9_dx_c0)


def _launch_conv9(g: torch.Tensor, weight: torch.Tensor, counter) -> torch.Tensor:
    """Kernel C on the current stream for a CUDA ``g``; adds one to
    ``counter.launches``, the entry point's count."""
    name = counter.__name__
    if g.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {g.device}")
    if g.dim() != 4 or g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes an (N, C, H, W) float32 or bfloat16 tensor, got {g.dtype} {tuple(g.shape)}")
    n, cout, h, w = g.shape
    if tuple(weight.shape[:1]) + tuple(weight.shape[2:]) != (cout, 9, 9) or weight.device != g.device:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} is not a 9x9 conv "
                         f"with {cout} outputs on {g.device}")
    if cout % _CHUNK or n > 65535:
        raise ValueError(f"{name} kernel takes C divisible by {_CHUNK} and at most 65535 images, got {cout}, {n}")
    if not g.is_contiguous(memory_format=torch.channels_last) or g.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs g in torch.channels_last memory format, 16-byte aligned")
    bf16 = g.dtype == torch.bfloat16
    if bf16:
        if cout != _BF16_COUT:
            raise ValueError(f"{name} bf16 kernel takes {_BF16_COUT} channels, got {cout}")
        wk = pack_wrev(weight.detach())
    else:  # wf[c][u][v] = W[c, 0, 8 - u, 8 - v]: the taps of channel 0, flipped, in f32
        wk = weight.detach()[:, 0].float().flip(1, 2).contiguous()
    out = torch.empty((n, 1, h, w), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(g.device):
        err = lib.climsr_conv9_dx_c0(g.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h, w, cout, int(bf16),
                                     torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter.launches += 1
    return out


conv9_dx_c0.launches = 0  # kernel launches since the count was last reset


class FusionConv1(torch.autograd.Function):
    """``apply(x, weight, bias)``: a SAME 9x9 conv computed in x's dtype (the
    parameters rounded to it at use) whose input gradient is kernel C for
    channel 0 and zero for channels 1+. Parameter gradients come back rounded
    to x's dtype and then in the parameters' own, as through flax's cast.

    The conv reads x in ``channels_last`` (x has 3 channels: a small copy
    where it comes NCHW), so its output, and the gradient that comes back,
    are NHWC as kernel C and cuDNN's dW conv read them: a 64-channel g that
    came NCHW would cost a full copy per step. dx is NCHW, channel 0 from C."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        wc = weight.to(x.dtype)
        xc = x.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(xc, wc)
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return F.conv2d(xc, wc, bias.to(x.dtype), padding=4)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dw = db = dx = None
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, wc.shape, g, padding=4).to(ctx.param_dtypes[0])
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3)).to(ctx.param_dtypes[1])
        if ctx.needs_input_grad[0]:
            dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
            dx[:, :1] = conv9_dx_c0(g, wc)
        return dx, dw, db


def fusion_conv1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The fusion head's conv1 with the channel-0 input gradient (see module docstring)."""
    return FusionConv1.apply(x, weight, bias)


# ---------------------------------------------------------------------------
# Kernel F: C's function with the probe's arguments, on C's kernel

DC0_VARIANTS = ("flat", "dyfac")  # the TPU probe's two plans (F1, F2)


def dc0_reference(g: torch.Tensor, w1c0: torch.Tensor) -> torch.Tensor:
    """The probe's function (``scripts/bench_head_bwd_probe.py:126``, kernel
    C's): ``out[n, y, x] = sum w1c0[4 - dy, 4 - dx, c] * g[n, c, y + dy, x + dx]``
    over dy, dx in -4..4 (g zero outside). ``g``: (N, C, H, W); ``w1c0``:
    (9, 9, C), read rounded to g's dtype (as the kernel's tensor cores read it)
    in f32; f32 sums; (N, 1, H, W) in g's dtype."""
    wrev = w1c0.to(g.dtype).float().flip(0, 1).permute(2, 0, 1).unsqueeze(0)  # (1, C, 9, 9)
    return F.conv2d(g.float(), wrev, padding=4).to(g.dtype)


def dc0_weight(w1c0: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Kernel C's weight for ``w1c0`` (9, 9, C): the (C, 1, 9, 9) view ``W[c,
    0, u, v] = w1c0[u, v, c]``, rounded to ``dtype`` as :func:`dc0_reference`
    reads it; ``conv9_dx_c0_reference(g, dc0_weight(w1c0, g.dtype))`` is
    ``dc0_reference(g, w1c0)``."""
    return w1c0.to(dtype).permute(2, 0, 1).unsqueeze(1)


def dc0(g: torch.Tensor, w1c0: torch.Tensor, variant: str = "flat") -> torch.Tensor:
    """Kernel F: :func:`dc0_reference`'s function, "flat" (F1,
    ``_dc0_kernel``) or "dyfac" (F2, ``_dc0_kernel_dyfac``). ``g``: (N, C, H,
    W) channels_last; ``w1c0``: (9, 9, C). On a CUDA tensor it launches kernel
    C (``csrc/conv9_dx_c0.cu``) on the current stream with
    :func:`dc0_weight`, or raises: bf16 takes C = 64 (the probe's width, C's),
    f32 any multiple of 16. It counts in ``dc0.launches`` and
    ``dc0.variant_launches``, not in ``conv9_dx_c0.launches``. ``variant`` is
    checked and counted and selects no other code: the TPU's two plans are
    two orders of one sum, which C's plan replaces on this card. On a CPU
    tensor it runs the plain version. A forward-only probe: it takes no
    gradient, and refuses inputs that need one."""
    if variant not in DC0_VARIANTS:
        raise ValueError(f"dc0 variant is 'flat' or 'dyfac', got {variant!r}")
    if torch.is_grad_enabled() and (g.requires_grad or w1c0.requires_grad):
        raise ValueError("dc0 is a forward-only probe and takes no gradient")
    if g.device.type == "cpu":
        return dc0_reference(g, w1c0)
    if g.dim() != 4 or tuple(w1c0.shape) != (9, 9, g.shape[1]):
        raise ValueError(f"w1c0 {tuple(w1c0.shape)} is not (9, 9, C) for g {tuple(g.shape)}")
    out = _launch_conv9(g, dc0_weight(w1c0, g.dtype), counter=dc0)
    dc0.variant_launches[variant] += 1
    return out


dc0.launches = 0  # kernel F launches (both variants) since the count was last reset
dc0.variant_launches = dict.fromkeys(DC0_VARIANTS, 0)  # the same, per variant (F1 "flat", F2 "dyfac")
