# -*- coding: utf-8 -*-
"""ESRGAN's fused HR tail: CUDA kernel E, its plain version and autograd.

The counterpart of ``climsr_tpu/ops/pallas/head.py``: lrelu -> HRconv 3x3
64->64 + bias -> lrelu -> conv_last 3x3 64->1 + bias, SAME padding.

- :func:`hr_tail_reference` is the plain version (``torch.nn.functional``
  convs in x's dtype, the parameters rounded to it), as the JAX
  ``hr_tail_reference`` (``head.py:154``).
- :func:`fused_hr_tail` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/hr_tail.cu`` (which replaces the TPU kernel
  ``_hr_tail_kernel``, ``head.py:58``) or raises; for a CPU tensor it runs the
  plain version. It counts its launches in ``fused_hr_tail.launches``. In
  bf16 the kernel's blocks are persistent (one per SM, its two warpgroups
  walking 12 x 16 output tiles each on their own); HRconv runs on ``wgmma``
  with all its weights resident in shared memory, packed by
  :func:`pack_hrconv` in the RDB chain's last-conv order, and conv_last on
  the tensor cores too, as a projection onto its 9 taps
  (:func:`pack_conv_last`) and shift-adds. f32 runs on the CUDA cores.
- :class:`FusedHRTail` carries the gradient: its backward is torch autograd
  through the plain version, the counterpart of the JAX ``custom_vjp``, whose
  backward is XLA's VJP of the reference (``head.py:189-200``).

Like the JAX package, the port does not wire the kernel into its ESRGAN: the
generator's head runs as library convs (``models/esrgan.py``). Rounding
follows the TPU kernel (``head.py:81-101``): lrelu(x) in f32 then rounded to
x's type; HRconv summed in f32, lrelu, rounded; conv_last summed in f32 and
rounded once. Unlike the TPU kernel (``hr_tail_eligible``, ``head.py:114``)
the CUDA kernel takes any H and W.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib
from climsr_tpu_torch.ops.rdb import _fragment_index_on, _needs_grad, chain_index

_SOURCES = ("hr_tail.cu",)
NF = 64  # the kernel's channel count (ESRGAN's nf at the flagship width)


@functools.lru_cache(maxsize=8)
def _hrconv_index_on(device: torch.device) -> torch.Tensor:
    """``chain_index(64, 64, last=True)`` kept on ``device``: one upload, not one per call."""
    return chain_index(NF, NF, last=True).to(device)


def pack_hrconv(whr: torch.Tensor) -> torch.Tensor:
    """HRconv's OIHW weights rounded to bf16 in the bf16 kernel's order: the
    RDB chain's last-conv packing (:func:`~climsr_tpu_torch.ops.rdb.chain_index`,
    k = tap * 64 + ci): k-step (16 input channels, tap), ci group outermost,
    each wgmma's K-major B tile of 16 k x 64 outputs without swizzle."""
    wk = whr.detach().to(torch.bfloat16).permute(0, 2, 3, 1).reshape(-1)
    return wk[_hrconv_index_on(whr.device)].contiguous()


def pack_conv_last(wcl: torch.Tensor) -> torch.Tensor:
    """conv_last's (1, 64, 3, 3) weights rounded to bf16 as the bf16 kernel's
    projection B: a (16, 64) matrix, row tap = 3 ky + kx (rows 9-15 zero), in
    ``mma.m16n8k16`` B-fragment order (:func:`~climsr_tpu_torch.ops.rdb.fragment_index`,
    4 k-steps of 16 channels)."""
    taps = wcl.detach().to(torch.bfloat16)[0].permute(1, 2, 0).reshape(9, NF)
    b = torch.cat([taps, taps.new_zeros(7, NF)])
    n_idx, k_idx = _fragment_index_on(16, NF, wcl.device)
    return b[n_idx, k_idx].contiguous()


def pack_tail(whr, bhr, wcl, bcl, dtype: torch.dtype):
    """The kernel's parameters for x's ``dtype``, rounded to it as the plain
    version reads them: (HRconv's weights, its bias, conv_last's weights, its
    bias). bf16: :func:`pack_hrconv`, :func:`pack_conv_last`; f32: HRconv
    tap-major [tap][cin][cout], conv_last [tap][cin]. Biases in f32."""
    if dtype == torch.bfloat16:
        wp, wl = pack_hrconv(whr), pack_conv_last(wcl)
    else:
        wp = whr.detach().float().permute(2, 3, 1, 0).contiguous()
        wl = wcl.detach().float()[0].permute(1, 2, 0).contiguous()
    bh = bhr.detach().to(dtype).float().contiguous()
    bl = bcl.detach().to(dtype).float().contiguous()
    return wp, bh, wl, bl


def hr_tail_reference(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x`` (N, 64, H, W); ``weights`` = (whr (64, 64, 3, 3), bhr (64,),
    wcl (1, 64, 3, 3), bcl (1,)), OIHW. Returns (N, 1, H, W) in x's dtype."""
    whr, bhr, wcl, bcl = weights

    def conv(v, wt, bs):
        return F.conv2d(v, wt.to(v.dtype), bs.to(v.dtype), padding=1)

    return conv(F.leaky_relu(conv(F.leaky_relu(x, 0.2), whr, bhr), 0.2), wcl, bcl)


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_hr_tail", _SOURCES)
    lib.climsr_hr_tail.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.climsr_hr_tail.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, whr, bhr, wcl, bcl) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"fused_hr_tail runs on CUDA or CPU tensors, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_hr_tail takes an (N, 64, H, W) float32 or bfloat16 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    want = {"whr": (NF, NF, 3, 3), "bhr": (NF,), "wcl": (1, NF, 3, 3), "bcl": (1,)}
    for name, t in zip(want, (whr, bhr, wcl, bcl)):
        if tuple(t.shape) != want[name] or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: expected {want[name]} on {x.device}")
    if c != NF or n > 65535:
        raise ValueError(f"fused_hr_tail kernel takes {NF} channels and at most 65535 images, got {c}, {n}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("fused_hr_tail kernel needs x in torch.channels_last memory format, 16-byte aligned")
    dt = x.dtype
    wp, bh, wl, bl = pack_tail(whr, bhr, wcl, bcl, dt)
    out = torch.empty((n, 1, h, w), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.climsr_hr_tail(x.data_ptr(), out.data_ptr(), wp.data_ptr(), bh.data_ptr(), wl.data_ptr(),
                                 bl.data_ptr(), n, h, w, int(dt == torch.bfloat16),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_hr_tail kernel launch failed: CUDA error {err}")
    fused_hr_tail.launches += 1
    return out


def fused_hr_tail(x: torch.Tensor, whr: torch.Tensor, bhr: torch.Tensor, wcl: torch.Tensor,
                  bcl: torch.Tensor) -> torch.Tensor:
    """Kernel E: as :func:`hr_tail_reference`. ``x`` (N, 64, H, W)
    channels_last, OIHW weights; returns (N, 1, H, W). Where autograd needs a
    gradient this is :class:`FusedHRTail`; otherwise a CUDA tensor launches
    the kernel on the current stream or raises, and a CPU tensor runs the
    plain version."""
    if _needs_grad(x, whr, bhr, wcl, bcl):
        return FusedHRTail.apply(x, whr, bhr, wcl, bcl)
    if x.device.type == "cpu":
        return hr_tail_reference(x, (whr, bhr, wcl, bcl))
    return _launch(x, whr, bhr, wcl, bcl)


fused_hr_tail.launches = 0  # kernel E launches since the count was last reset


class FusedHRTail(torch.autograd.Function):
    """``apply(x, whr, bhr, wcl, bcl)``: the forward is kernel E (the plain
    version on the CPU); the backward is autograd through
    :func:`hr_tail_reference` on the saved inputs, as the JAX ``custom_vjp``
    takes XLA's VJP of its reference."""

    @staticmethod
    def forward(ctx, x, whr, bhr, wcl, bcl):
        ctx.save_for_backward(x, whr, bhr, wcl, bcl)
        if x.device.type == "cpu":
            return hr_tail_reference(x, (whr, bhr, wcl, bcl))
        return _launch(x, whr, bhr, wcl, bcl)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = hr_tail_reference(inputs[0], inputs[1:])
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)
