"""The plain ESRGAN generator with its fusion head, as the benchmark's reference.

Plain PyTorch convolutions on a dict of parameters named as the port's
``state_dict`` (``RRDB_trunk.{i}.RDB{j}.conv{k}.weight`` ...), so that the
same seeded weights load into both. It follows Wang et al., ESRGAN
(arXiv:1809.00219) and the upstream climsr model: conv_first -> nb RRDBs
(three residual dense blocks of five 3x3 convs with growth gc, LeakyReLU 0.2,
residual scale 0.2 on each block and on the RRDB) -> trunk_conv + skip ->
[nearest x2, 3x3 conv, LeakyReLU] per factor of 2 -> HRconv, LeakyReLU ->
conv_last -> SRCNN fusion head (9x9 -> 64, ReLU, 1x1 -> 32, ReLU, 5x5 -> out)
over the output, the HR elevation and the HR mask.

Its RDB is a frozen copy of the port's ``ops/rdb.py`` ``rdb_reference``.
It computes in float32 with TF32 off (:func:`exact_matmul`), or, as the
control that must come out not correct, with every conv computed in float8
(:func:`fp8_conv`: input, weight and output in e4m3, the gradient in e5m2,
per-tensor scales).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Conv = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor]

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0  # the largest float8 e4m3fn and e5m2 values


def param_shapes(gen: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the generator ``gen`` (nf, nb, gc,
    in_channels, out_channels, scaling_factor), in the port's order."""
    nf, nb, gc = gen["nf"], gen["nb"], gen["gc"]
    cin, cout = gen["in_channels"], gen["out_channels"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, o, i, k=3):
        out.append((f"{name}.weight", (o, i, k, k)))
        out.append((f"{name}.bias", (o,)))

    conv("conv_first", nf, cin)
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(4):
                conv(f"RRDB_trunk.{i}.RDB{j}.conv{k + 1}", gc, nf + k * gc)
            conv(f"RRDB_trunk.{i}.RDB{j}.conv5", nf, nf + 4 * gc)
    conv("trunk_conv", nf, nf)
    conv("upconv1", nf, nf)
    if gen["scaling_factor"] == 4:
        conv("upconv2", nf, nf)
    conv("HRconv", nf, nf)
    conv("conv_last", cout, nf)
    conv("srcnn.conv1", 64, cout + 2, 9)
    conv("srcnn.conv2", 32, 64, 1)
    conv("srcnn.conv3", cout, 32, 5)
    return out


def seeded_params(gen: dict, seed: int, device: torch.device) -> Params:
    """Weights and biases drawn U(+-1/sqrt(fan_in)) (torch's default conv
    init, the port's ``init_torch_default_`` distribution) from ``seed``, on
    ``device`` in float32: one draw for the whole model, cut into tensors."""
    shapes = param_shapes(gen)
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    params, at = {}, 0
    fan_in = 1
    for (name, shape), size in zip(shapes, sizes):
        if name.endswith(".weight"):
            fan_in = math.prod(shape[1:])
        params[name] = flat[at:at + size].view(shape).mul(1.0 / math.sqrt(fan_in))
        at += size
    return params


def f32_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: int) -> torch.Tensor:
    return F.conv2d(x, w, b, padding=padding)


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to a float8 type under a per-tensor scale (amax -> the type's largest value)."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in t's dtype;
    the gradient passes straight through."""
    return t + (_round8(t.detach(), torch.float8_e4m3fn, _E4M3_MAX) - t).detach()


class _Fp8Conv(torch.autograd.Function):
    """A conv computed in float8: input, weight and output in e4m3, the
    incoming gradient in e5m2, each under a per-tensor scale; products summed
    in float32 (a bf16 program rounds each of them to bf16)."""

    @staticmethod
    def forward(ctx, x, w, b, padding, stride):
        xq = _round8(x, torch.float8_e4m3fn, _E4M3_MAX)
        wq = _round8(w, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        ctx.padding, ctx.stride, ctx.bias = padding, stride, b is not None
        return _round8(F.conv2d(xq, wq, b, stride=stride, padding=padding), torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round8(g, torch.float8_e5m2, _E5M2_MAX)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride=ctx.stride, padding=ctx.padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride=ctx.stride, padding=ctx.padding)
        return gx, gw, g.sum((0, 2, 3)) if ctx.bias else None, None, None


def fp8_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: int, stride: int = 1) -> torch.Tensor:
    """The control's conv (:class:`_Fp8Conv`)."""
    return _Fp8Conv.apply(x, w, b, padding, stride)


@contextlib.contextmanager
def exact_matmul() -> Iterator[None]:
    """float32 convs and matmuls in float32 (no TF32) inside the block."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def rdb(x: torch.Tensor, p: Params, prefix: str, conv: Conv) -> torch.Tensor:
    """x + 0.2 * conv5([x, h1 .. h4]), h_k = lrelu(conv_k([x, h1 .. h_{k-1}]))."""
    feats = [x]
    for k in range(1, 5):
        h = conv(torch.cat(feats, 1), p[f"{prefix}.conv{k}.weight"], p[f"{prefix}.conv{k}.bias"], 1)
        feats.append(F.leaky_relu(h, 0.2))
    return conv(torch.cat(feats, 1), p[f"{prefix}.conv5.weight"], p[f"{prefix}.conv5.bias"], 1) * 0.2 + x


def forward(p: Params, gen: dict, lr: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor,
            conv: Conv = f32_conv) -> torch.Tensor:
    """(N, in_channels, h, w) LR input and (N, 1, h*s, w*s) HR elevation and
    mask -> (N, out_channels, h*s, w*s)."""

    def c(name, v, pad=1):
        return conv(v, p[f"{name}.weight"], p[f"{name}.bias"], pad)

    fea = c("conv_first", lr)
    trunk = fea
    for i in range(gen["nb"]):
        out = trunk
        for j in (1, 2, 3):
            out = rdb(out, p, f"RRDB_trunk.{i}.RDB{j}", conv)
        trunk = out * 0.2 + trunk
    fea = fea + c("trunk_conv", trunk)
    ups = ["upconv1", "upconv2"] if gen["scaling_factor"] == 4 else ["upconv1"]
    for name in ups:
        fea = F.leaky_relu(c(name, F.interpolate(fea, scale_factor=2, mode="nearest")), 0.2)
    out = c("conv_last", F.leaky_relu(c("HRconv", fea), 0.2))
    h = F.relu(c("srcnn.conv1", torch.cat([out, elev, mask], 1), 4))
    h = F.relu(c("srcnn.conv2", h, 0))
    return c("srcnn.conv3", h, 2)
