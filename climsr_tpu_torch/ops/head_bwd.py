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
  the plain version. It counts its launches in ``conv9_dx_c0.launches``.
- :class:`FusionConv1` (:func:`fusion_conv1`) is the head's conv1 with that
  backward (``head_bwd.py:124-160``): the forward and dW/db are the library's
  convs, as the JAX package leaves them to XLA; dX is the kernel, exact for
  channel 0 and ZERO for channels 1+. It is valid only where those channels'
  gradients are discarded: ESRGAN turns it on only with one output channel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib

_SOURCES = ("conv9_dx_c0.cu",)
_CHUNK = 16  # the kernel walks the output channels 16 at a time


def conv9_dx_c0_reference(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dX of a SAME 9x9 conv for input channel 0. ``g``: (N, cout, H, W);
    ``weight``: (cout, cin, 9, 9) in the compute dtype. Returns (N, 1, H, W) in g's dtype."""
    n, _, h, w = g.shape
    w0 = weight[:, :1].float()
    return torch.nn.grad.conv2d_input((n, 1, h, w), w0, g.float(), padding=4).to(g.dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_head_bwd", _SOURCES)
    lib.climsr_conv9_dx_c0.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.climsr_conv9_dx_c0.restype = ctypes.c_int
    return lib


def conv9_dx_c0(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Kernel C: as :func:`conv9_dx_c0_reference`. On a CUDA tensor it launches
    the kernel on the current stream or raises; on a CPU tensor it runs the
    plain version. ``g`` must be channels_last (NHWC storage)."""
    if g.device.type == "cpu":
        return conv9_dx_c0_reference(g, weight)
    if g.device.type != "cuda":
        raise ValueError(f"conv9_dx_c0 runs on CUDA or CPU tensors, got {g.device}")
    if g.dim() != 4 or g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv9_dx_c0 takes an (N, C, H, W) float32 or bfloat16 tensor, "
                        f"got {g.dtype} {tuple(g.shape)}")
    n, cout, h, w = g.shape
    if tuple(weight.shape[:1]) + tuple(weight.shape[2:]) != (cout, 9, 9) or weight.device != g.device:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} is not a 9x9 conv "
                         f"with {cout} outputs on {g.device}")
    if cout % _CHUNK or n > 65535:
        raise ValueError(f"conv9_dx_c0 kernel takes cout divisible by {_CHUNK} and at most 65535 images, "
                         f"got {cout}, {n}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv9_dx_c0 kernel needs g in torch.channels_last memory format")
    # wf[c][u][v] = W[c, 0, 8 - u, 8 - v]: the taps of channel 0, flipped, in f32
    wf = weight[:, 0].float().flip(1, 2).contiguous()
    out = torch.empty((n, 1, h, w), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(g.device):
        err = lib.climsr_conv9_dx_c0(g.data_ptr(), wf.data_ptr(), out.data_ptr(), n, h, w, cout,
                                     int(g.dtype == torch.bfloat16), torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv9_dx_c0 kernel launch failed: CUDA error {err}")
    conv9_dx_c0.launches += 1
    return out


conv9_dx_c0.launches = 0  # kernel launches since the count was last reset


class FusionConv1(torch.autograd.Function):
    """``apply(x, weight, bias)``: a SAME 9x9 conv computed in x's dtype (the
    parameters rounded to it at use) whose input gradient is kernel C for
    channel 0 and zero for channels 1+. Parameter gradients come back rounded
    to x's dtype and then in the parameters' own, as through flax's cast."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        wc = weight.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return F.conv2d(x, wc, bias.to(x.dtype), padding=4)

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
            dx = torch.zeros_like(x)
            dx[:, :1] = conv9_dx_c0(g, wc)
        return dx, dw, db


def fusion_conv1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The fusion head's conv1 with the channel-0 input gradient (see module docstring)."""
    return FusionConv1.apply(x, weight, bias)
