# -*- coding: utf-8 -*-
"""The ESRGAN discriminator's chain between its convolutions: CUDA kernels and autograd.

Each block of :class:`~climsr_tpu_torch.models.discriminator.Discriminator`
runs conv3, bias, LeakyReLU(0.01), BatchNorm, reflect-pad 1, strided conv3,
bias, LeakyReLU(0.01) and the next block's reflect-pad 1. With each conv run
without its bias, what lies between the convs is two ops:

- :func:`bias_leaky_bn_pad` ``(y, bias, bn, slope)``: ``pad(bn(lrelu(y + bias)))``,
  ``bn`` a ``TorchBatchNorm`` in train mode (batch statistics; the running
  statistics and ``num_batches_tracked`` updated as the module updates them)
  or eval mode (its running statistics);
- :func:`bias_leaky_pad` ``(y, bias, slope)``: ``pad(lrelu(y + bias))``;

``pad`` the reflection by one pixel on each side. Both keep the module
chain's roundings: the bias is rounded to y's dtype, the add and the
LeakyReLU each round to it, BatchNorm runs in f32 on that rounded value and
its result is rounded once. Their backward folds the pad's border gradients
in f32 and rounds the fold once to y's dtype, as the pad's gradient is in the
chain; BatchNorm's input gradient (f32) is rounded to y's dtype (the chain's
cast back), then the LeakyReLU mask; the conv bias' gradient is the f32 sum
of that, rounded to y's dtype and then to the bias' own, as through
``TorchConv``'s cast. BatchNorm's weight and bias gradients stay f32. Only
the gradients ``ctx.needs_input_grad`` asks for are made: with D's parameters
frozen (the generator's step) the backward writes the input's gradient alone.

For a CUDA tensor (bf16 or f32, NCHW in ``torch.channels_last``, C a multiple
of 8, H and W at least 2) each op launches the hand-written kernels of
``csrc/d_tail.cu`` or raises; for a CPU tensor it runs the plain versions,
which repeat the kernels' arithmetic: :func:`bn_stats_reference`,
:func:`bias_leaky_bn_pad_reference` and
:func:`bias_leaky_bn_pad_backward_reference`, :func:`bias_leaky_pad_reference`
and :func:`bias_leaky_pad_backward_reference`. The kernels replace no TPU
kernel (the JAX package's discriminator runs on XLA's fusions); they exist
because PyTorch runs the chain as one pass over the activation per step and
copies it in f32 for BatchNorm (see the source's note). Each op counts its
forward calls through the kernels in ``.launches`` and its backward calls in
``.backward_launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops import cuda_lib

_SOURCES = ("d_tail.cu",)
_CHUNK = 64  # a kernel block's channels (8 lanes of 8)
_BLOCKS = 1056  # blocks a launch aims for: 8 of 256 threads on each of an H100's 132 SMs


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The statistics' dtype: f32, or f64 for an f64 input."""
    return torch.promote_types(dtype, torch.float32)


def _per_channel(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).view(1, -1, 1, 1)


def _act(y: torch.Tensor, bias: torch.Tensor, slope: float) -> torch.Tensor:
    """lrelu(y + bias) in y's dtype: the bias rounded to it, the add and the LeakyReLU each rounded."""
    return F.leaky_relu(y + _per_channel(bias, y.dtype), slope)


def _pad(t: torch.Tensor) -> torch.Tensor:
    return F.pad(t, (1, 1, 1, 1), mode="reflect")


def fold_reflect_pad1(gp: torch.Tensor) -> torch.Tensor:
    """The gradient at the input of a reflect pad 1 from its output's ``gp``
    (N, C, H + 2, W + 2): each source pixel's padded positions summed, in f32
    (f64 for f64 ``gp``). Needs H, W >= 2."""
    g = gp.to(_acc(gp.dtype))
    h, w = g.shape[2] - 2, g.shape[3] - 2
    rows = g[:, :, 1:-1].clone()
    rows[:, :, 1] += g[:, :, 0]
    rows[:, :, h - 2] += g[:, :, -1]
    out = rows[..., 1:-1].clone()
    out[..., 1] += rows[..., 0]
    out[..., w - 2] += rows[..., -1]
    return out


def _rstd(var: torch.Tensor, eps: float) -> torch.Tensor:
    return 1 / torch.sqrt(var + eps)


def bn_stats_reference(y: torch.Tensor, bias: torch.Tensor, slope: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per channel, the mean and biased variance of ``lrelu(y + bias)`` in f32 (f64 for f64 ``y``)."""
    a = _act(y, bias, slope).to(_acc(y.dtype))
    return a.mean((0, 2, 3)), a.var((0, 2, 3), unbiased=False)


def bias_leaky_bn_pad_reference(y: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor, bn_bias: torch.Tensor,
                                mean: torch.Tensor, var: torch.Tensor, eps: float, slope: float) -> torch.Tensor:
    """``pad(bn(lrelu(y + bias)))`` normalised with ``mean`` and ``var`` (the
    batch's, or the running statistics in eval mode): ``((a - mean) * rstd) *
    weight + bn_bias`` in f32, rounded to y's dtype, padded. (N, C, H + 2, W + 2)."""
    acc = _acc(y.dtype)
    a = _act(y, bias, slope).to(acc)
    z = (a - _per_channel(mean, acc)) * _per_channel(_rstd(var.to(acc), eps), acc) * _per_channel(weight, acc) \
        + _per_channel(bn_bias, acc)
    return _pad(z.to(y.dtype))


def bias_leaky_bn_pad_backward_reference(gp: torch.Tensor, y: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor,
                                         mean: torch.Tensor, var: torch.Tensor, eps: float, slope: float,
                                         train: bool) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`bias_leaky_bn_pad_reference` for the output's
    gradient ``gp``: (dy in y's dtype, dbias in y's dtype, dweight and dbn_bias
    in f32). ``train``: ``mean`` and ``var`` are the batch's, so BatchNorm's
    input gradient carries their dependence on y (torch's formula: ``(g -
    mean(g) - (a - mean) * rstd^2 * mean(g (a - mean))) * weight * rstd``)."""
    acc = _acc(y.dtype)
    g = fold_reflect_pad1(gp).to(y.dtype).to(acc)
    a = _act(y, bias, slope)
    xmu = a.to(acc) - _per_channel(mean, acc)
    rstd = _rstd(var.to(acc), eps)
    dbn_bias = g.sum((0, 2, 3))
    dweight = (g * xmu).sum((0, 2, 3)) * rstd
    scale = _per_channel(weight.to(acc) * rstd, acc)
    if train:
        count = g.numel() // g.shape[1]
        g = g - _per_channel(dbn_bias / count, acc) - xmu * _per_channel(rstd * dweight / count, acc)
    da = (g * scale).to(y.dtype)
    dy = torch.where(a > 0, da, da * slope)
    return dy, dy.to(acc).sum((0, 2, 3)).to(y.dtype), dweight, dbn_bias


def bias_leaky_pad_reference(y: torch.Tensor, bias: torch.Tensor, slope: float) -> torch.Tensor:
    """``pad(lrelu(y + bias))`` in y's dtype, (N, C, H + 2, W + 2)."""
    return _pad(_act(y, bias, slope))


def bias_leaky_pad_backward_reference(gp: torch.Tensor, out: torch.Tensor, slope: float) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`bias_leaky_pad_reference` for the output's
    gradient ``gp``, from its output ``out`` (whose sign is the LeakyReLU
    input's): (dy, dbias), both in out's dtype."""
    g = fold_reflect_pad1(gp).to(out.dtype)
    dy = torch.where(out[:, :, 1:-1, 1:-1] > 0, g, g * slope)
    return dy, dy.to(_acc(dy.dtype)).sum((0, 2, 3)).to(dy.dtype)


# ---------------------------------------------------------------------------
# The kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("climsr_d_tail", _SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.climsr_d_tail_bn_fwd.argtypes = [p] * 10 + [i] * 6 + [f] * 3 + [i, p, p]
    lib.climsr_d_tail_bn_bwd.argtypes = [p] * 10 + [i] * 6 + [f] * 2 + [i, p]
    lib.climsr_d_tail_pad_fwd.argtypes = [p] * 2 + [i] * 5 + [f, i, p, p]
    lib.climsr_d_tail_pad_bwd.argtypes = [p] * 4 + [i] * 5 + [f, i, p, p]
    for fn in (lib.climsr_d_tail_bn_fwd, lib.climsr_d_tail_bn_bwd, lib.climsr_d_tail_pad_fwd,
               lib.climsr_d_tail_pad_bwd):
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _nhwc(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the kernels read it: a CUDA (N, C, H, W) bf16 or f32 tensor in
    channels_last storage, 16-byte aligned, C a multiple of 8, H and W >= 2."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")
    if t.dim() != 4 or t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes an (N, C, H, W) float32 or bfloat16 tensor, got {t.dtype} {tuple(t.shape)}")
    t = t.contiguous(memory_format=torch.channels_last)
    _, c, h, w = t.shape
    if c % 8 or h < 2 or w < 2 or t.data_ptr() % 16:
        raise ValueError(f"{name} kernels take C a multiple of 8 and H, W >= 2, 16-byte aligned; "
                         f"got {tuple(t.shape)}")
    return t


def _f32(t: torch.Tensor, c: int, name: str) -> torch.Tensor:
    if t.numel() != c or t.device.type != "cuda":
        raise ValueError(f"{name}: a per-channel tensor {tuple(t.shape)} on {t.device} for {c} channels")
    return t.detach().float().contiguous()


def _parts(pixels: int, c: int) -> int:
    """grid.x of every launch of a call: contiguous parts of the pixels, so that
    about ``_BLOCKS`` blocks cover the 64-channel chunks, 32 pixels at least each."""
    return max(1, min(-(-pixels // 32), _BLOCKS // -(-c // _CHUNK)))


def _launch(name: str, entry: str, t: torch.Tensor, *args) -> None:
    """The library's ``entry`` on ``args`` and the current stream of t's
    device (made the current device for the call); raises on a CUDA error."""
    on = contextlib.nullcontext() if t.device.index == torch.cuda.current_device() else torch.cuda.device(t.device)
    with on:
        err = getattr(_library(), entry)(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _bn_fwd(y, bias, weight, bn_bias, running_mean, running_var, nbt, training, momentum, eps, slope):
    name = "bias_leaky_bn_pad"
    y = _nhwc(y, name)
    n, c, h, w = y.shape
    bias, weight, bn_bias = (_f32(t, c, name) for t in (bias, weight, bn_bias))
    if running_mean.dtype != torch.float32 or running_var.dtype != torch.float32 or nbt.dtype != torch.int64:
        raise TypeError(f"{name} updates float32 running statistics and an int64 count")
    out = torch.empty((n, c, h + 2, w + 2), dtype=y.dtype, device=y.device, memory_format=torch.channels_last)
    parts = _parts(n * h * w, c)
    if training:  # the batch's mean and variance, then the partials
        buf = torch.empty(2 * c * (parts + 1), dtype=torch.float32, device=y.device)
        mean, var, part = buf[:c], buf[c:2 * c], buf[2 * c:]
        update = (running_mean, running_var, nbt)
    else:  # copies: a later train-mode call updates the buffers in place before this call's backward
        part, update = None, (None, None, None)
        mean, var = running_mean.clone(), running_var.clone()
    _launch(name, "climsr_d_tail_bn_fwd", y, *map(_ptr, (y, bias, weight, bn_bias, mean, var, *update, part)),
            n, h, w, c, parts, int(training), momentum, eps, slope, int(y.dtype == torch.bfloat16), out.data_ptr())
    bias_leaky_bn_pad.launches += 1
    return y, out, mean, var


def _bn_bwd(gp, y, bias, weight, mean, var, training, eps, slope, need):
    name = "bias_leaky_bn_pad"
    gp = _nhwc(gp.to(y.dtype), name)
    n, c, h, w = y.shape
    bias, weight = _f32(bias, c, name), _f32(weight, c, name)
    need_dy = need[0] or need[1]
    need_sums = need[2] or need[3] or (training and need_dy)
    parts = _parts(n * h * w, c)
    buf = torch.empty(c * (3 + 2 * parts), dtype=torch.float32, device=y.device)  # sums, db, the partials
    sums = buf[:2 * c].view(2, c) if need_sums else None
    db = buf[2 * c:3 * c] if need[1] else None
    dy = torch.empty_like(y, memory_format=torch.channels_last) if need_dy else None
    _launch(name, "climsr_d_tail_bn_bwd", y, *map(_ptr, (gp, y, bias, weight, mean, var, buf[3 * c:], sums, dy, db)),
            n, h, w, c, parts, int(training), eps, slope, int(y.dtype == torch.bfloat16))
    bias_leaky_bn_pad.backward_launches += 1
    dbn_bias, dweight = (None, None) if sums is None else sums
    return dy, db, dweight, dbn_bias


class _BiasLeakyBnPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, weight, bn_bias, running_mean, running_var, nbt, training, momentum, eps, slope):
        if y.device.type == "cpu":
            if training:
                mean, var = bn_stats_reference(y, bias, slope)
                count = y.numel() // y.shape[1]
                running_mean.copy_(momentum * mean + (1 - momentum) * running_mean)
                running_var.copy_(momentum * var * count / (count - 1) + (1 - momentum) * running_var)
                nbt.add_(1)
            else:
                mean, var = running_mean.clone(), running_var.clone()
            out = bias_leaky_bn_pad_reference(y, bias, weight, bn_bias, mean, var, eps, slope)
        else:
            y, out, mean, var = _bn_fwd(y, bias, weight, bn_bias, running_mean, running_var, nbt, training,
                                        momentum, eps, slope)
        ctx.save_for_backward(y, bias, weight, mean, var)
        ctx.config = (training, eps, slope)
        return out

    @staticmethod
    def backward(ctx, gp):
        y, bias, weight, mean, var = ctx.saved_tensors
        training, eps, slope = ctx.config
        need = ctx.needs_input_grad[:4]
        if gp.device.type == "cpu":
            grads = bias_leaky_bn_pad_backward_reference(gp, y, bias, weight, mean, var, eps, slope, training)
        else:
            grads = _bn_bwd(gp, y, bias, weight, mean, var, training, eps, slope, need)
        # db is in y's dtype (on a card the kernel rounds it to it), then in the
        # parameter's own, as through TorchConv's cast
        dy, db, dweight, dbn_bias = (gr if nd else None for gr, nd in zip(grads, need))
        return (dy, None if db is None else db.to(bias.dtype), None if dweight is None else dweight.to(weight.dtype),
                None if dbn_bias is None else dbn_bias.to(weight.dtype)) + (None,) * 7


def bias_leaky_bn_pad(y: torch.Tensor, bias: torch.Tensor, bn: torch.nn.BatchNorm2d,
                      slope: float = 0.01) -> torch.Tensor:
    """``pad(bn(lrelu(y + bias)))`` (module docstring): ``y`` (N, C, H, W) the
    conv's output without its bias, ``bias`` (C,), ``bn`` an affine BatchNorm
    with running statistics, in train or eval mode. Returns (N, C, H + 2, W +
    2) in y's dtype, channels_last on a card. Differentiable in y, bias and
    bn's weight and bias; in train mode it updates bn's running statistics
    and ``num_batches_tracked``."""
    if bn.weight is None or bn.running_mean is None or bn.momentum is None:
        raise ValueError("bias_leaky_bn_pad takes an affine BatchNorm with running statistics and a momentum")
    return _BiasLeakyBnPad.apply(y, bias, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                 bn.num_batches_tracked, bn.training, bn.momentum, bn.eps, slope)


bias_leaky_bn_pad.launches = 0  # forward calls through the kernels since the count was last reset
bias_leaky_bn_pad.backward_launches = 0  # backward calls through the kernels


class _BiasLeakyPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, slope):
        if y.device.type == "cpu":
            out = bias_leaky_pad_reference(y, bias, slope)
        else:
            name = "bias_leaky_pad"
            y = _nhwc(y, name)
            n, c, h, w = y.shape
            out = torch.empty((n, c, h + 2, w + 2), dtype=y.dtype, device=y.device,
                              memory_format=torch.channels_last)
            _launch(name, "climsr_d_tail_pad_fwd", y, y.data_ptr(), _f32(bias, c, name).data_ptr(), n, h, w, c,
                    _parts(n * h * w, c), slope, int(y.dtype == torch.bfloat16), out.data_ptr())
            bias_leaky_pad.launches += 1
        ctx.save_for_backward(out)
        ctx.config = (slope, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, gp):
        (out,) = ctx.saved_tensors
        slope, bias_dtype = ctx.config
        need_dy, need_db = ctx.needs_input_grad[:2]
        if gp.device.type == "cpu":
            dy, db = bias_leaky_pad_backward_reference(gp, out, slope)
        else:
            name = "bias_leaky_pad"
            gp = _nhwc(gp.to(out.dtype), name)
            n, c, hp, wp = out.shape
            h, w = hp - 2, wp - 2
            parts = _parts(n * h * w, c)
            buf = torch.empty(c * (parts + 1), dtype=torch.float32, device=out.device) if need_db else None
            db, part = (None, None) if buf is None else (buf[:c], buf[c:])  # db rounded to out's dtype
            dy = torch.empty((n, c, h, w), dtype=out.dtype, device=out.device, memory_format=torch.channels_last)
            _launch(name, "climsr_d_tail_pad_bwd", out, gp.data_ptr(), out.data_ptr(), _ptr(part), _ptr(db), n, h, w,
                    c, parts, slope, int(out.dtype == torch.bfloat16), dy.data_ptr())
            bias_leaky_pad.backward_launches += 1
        return (dy if need_dy else None, db.to(bias_dtype) if need_db else None, None)


def bias_leaky_pad(y: torch.Tensor, bias: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """``pad(lrelu(y + bias))`` (module docstring): ``y`` (N, C, H, W) the
    strided conv's output without its bias, ``bias`` (C,). Returns (N, C, H +
    2, W + 2) in y's dtype, channels_last on a card. Differentiable in y and bias."""
    return _BiasLeakyPad.apply(y, bias, slope)


bias_leaky_pad.launches = 0  # forward calls through the kernels since the count was last reset
bias_leaky_pad.backward_launches = 0  # backward calls through the kernels
