"""The plain RFB-ESRGAN generator and its pixel-loss pre-training steps, as
the benchmark's reference.

Shang et al., "Perceptual Extreme Super Resolution Network with Receptive
Field Block" (CVPR 2020 workshops, arXiv:2005.12597), as the upstream climsr
model (``climsr/models/rfb_esrgan.py``) and the two packages read it:

- a 3x3 conv (``conv1``) to 64 features;
- ``Trunk_A``: 16 RRDBs, each three bias-free residual dense blocks (four
  3x3 growth convs of 32 over the growing concatenation, LeakyReLU 0.2, a 3x3
  conv back to 64, ``x + 0.2 * conv5``) and ``x + 0.2 * RDB3(RDB2(RDB1(x)))``;
- ``Trunk_RFB``: 8 RRFDBs, each three receptive-field dense blocks (five
  RFBs over the growing concatenation, the first four growing it by 32 and
  ending in LeakyReLU 0.2, the fifth back to 64 without it; ``x + 0.2 *
  RFB5``) and ``x + 0.2 * RFDB3(RFDB2(RFDB1(x)))``;
- the receptive-field block (RFB) on ``cin`` channels, c = cin / 4: a 1x1
  shortcut and four branches, each opened by a 1x1 conv and ReLU: (1) 3x3;
  (2) (1,3), ReLU, 3x3 at dilation 3; (3) (3,1), ReLU, 3x3 at dilation 3;
  (4) to c/2, (1,3) to 3c/4, ReLU, (1,3) to c, ReLU, 3x3 at dilation 5; the
  branches concatenated, a 1x1 merge, ``merge * 0.2 + shortcut``, then
  LeakyReLU 0.2 where the block has it. Every RFB and RDB conv is bias-free;
- the middle RFB (no LeakyReLU) over ``conv1 + trunk``;
- per factor of 4: nearest x2, an RFB, a 3x3 conv to 256, LeakyReLU 0.2, a
  pixel shuffle of 2, an RFB;
- a 3x3 conv (``conv3``) and LeakyReLU 0.2, a 3x3 conv (``conv4``) to the
  output channels and tanh.

Departures from the paper, as upstream climsr and the port run it: x4 (one
upsampling stage) where the paper upsamples x16; 3 channels in (climate, LR
elevation, LR mask) and 1 out; a tanh output; and the fourth branch's second
asymmetric conv is (1,3) again, where the paper's branch is 1x3 then 3x1.

Plain PyTorch on a dict of parameters named as the port's ``state_dict``
(``conv1.weight``, ``Trunk_A.{i}.RDB{j}.conv{1..4}.0.weight``,
``.conv5.weight``, ``Trunk_RFB.{i}.RFDB{j}.RFB{m}.{shortcut, branch{b}.{2k},
conv1x1}.weight``, ``RFB.*``, ``upsampling.{1, 2, 5}.*``, ``conv3.0.weight``,
``conv4.0.weight``). It computes in float32 with TF32 off
(``esrgan.exact_matmul``), or, as the control that must come out not
correct, with every conv in float8 (:func:`fp8_conv`, ``esrgan.fp8_conv``'s
rounding with dilation). The steps reuse ``train.py``'s epoch order, batches,
one-cycle schedule and AdamW; only the generator differs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import esrgan, train

Params = Dict[str, torch.Tensor]
Pad = Union[int, Tuple[int, int]]
Conv = Callable[[torch.Tensor, torch.Tensor, Pad, int], torch.Tensor]  # (x, weight, padding, dilation)

NF, GC = 64, 32  # the generator's features and growth, fixed in the model


def rfb_convs(cin: int, cout: int) -> List[Tuple[str, Tuple[int, ...], Pad, int]]:
    """(name, OIHW shape, padding, dilation) of an RFB's convs, in the port's order."""
    c = cin // 4
    return [("shortcut", (cout, cin, 1, 1), 0, 1),
            ("branch1.0", (c, cin, 1, 1), 0, 1), ("branch1.2", (c, c, 3, 3), 1, 1),
            ("branch2.0", (c, cin, 1, 1), 0, 1), ("branch2.2", (c, c, 1, 3), (0, 1), 1),
            ("branch2.4", (c, c, 3, 3), 3, 3),
            ("branch3.0", (c, cin, 1, 1), 0, 1), ("branch3.2", (c, c, 3, 1), (1, 0), 1),
            ("branch3.4", (c, c, 3, 3), 3, 3),
            ("branch4.0", (c // 2, cin, 1, 1), 0, 1), ("branch4.2", (c // 4 * 3, c // 2, 1, 3), (0, 1), 1),
            ("branch4.4", (c, c // 4 * 3, 1, 3), (0, 1), 1), ("branch4.6", (c, c, 3, 3), 5, 5),
            ("conv1x1", (cout, 4 * c, 1, 1), 0, 1)]


def upsampling_stages(gen: dict) -> int:
    s, stages = gen["scaling_factor"], 0
    while s > 1 and s % 4 == 0:
        s, stages = s // 4, stages + 1
    if s != 1:
        raise ValueError(f"RFB-ESRGAN upsamples in x4 stages, not by {gen['scaling_factor']}")
    return stages


def rfb_prefixes(gen: dict) -> List[Tuple[str, int, int]]:
    """(prefix, cin, cout) of every RFB, in the port's order (its span keys)."""
    out = []
    for i in range(gen["num_rrfdb_blocks"]):
        for j in (1, 2, 3):
            for m in range(1, 6):
                out.append((f"Trunk_RFB.{i}.RFDB{j}.RFB{m}", NF + (m - 1) * GC, GC if m < 5 else NF))
    out.append(("RFB", NF, NF))
    for b in range(upsampling_stages(gen)):
        out += [(f"upsampling.{6 * b + 1}", NF, NF), (f"upsampling.{6 * b + 5}", NF, NF)]
    return out


def param_shapes(gen: dict) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, shape, kaiming) of every parameter of the generator ``gen``
    (num_rrdb_blocks, num_rrfdb_blocks, in_channels, out_channels,
    scaling_factor), in the port's order; ``kaiming`` marks the RFB and RDB
    convs, which the model draws kaiming-normal x0.1."""
    out: List[Tuple[str, Tuple[int, ...], bool]] = [("conv1.weight", (NF, gen["in_channels"], 3, 3), False)]
    for i in range(gen["num_rrdb_blocks"]):
        for j in (1, 2, 3):
            out += [(f"Trunk_A.{i}.RDB{j}.conv{k}.0.weight", (GC, NF + (k - 1) * GC, 3, 3), True) for k in range(1, 5)]
            out.append((f"Trunk_A.{i}.RDB{j}.conv5.weight", (NF, NF + 4 * GC, 3, 3), True))
    for prefix, cin, cout in rfb_prefixes(gen):
        out += [(f"{prefix}.{name}.weight", shape, True) for name, shape, _, _ in rfb_convs(cin, cout)]
        if prefix.startswith("upsampling.") and int(prefix.split(".")[1]) % 6 == 1:  # the conv to 256 follows it
            out.append((f"upsampling.{int(prefix.split('.')[1]) + 1}.weight", (4 * NF, NF, 3, 3), False))
    out += [("conv3.0.weight", (NF, NF, 3, 3), False), ("conv4.0.weight", (gen["out_channels"], NF, 3, 3), False)]
    return out


def seeded_params(gen: dict, seed: int, device: torch.device) -> Params:
    """The model's own initial distributions drawn from ``seed`` on ``device``
    in float32: N(0, (0.1 sqrt(2 / fan_in))^2) on the RFB and RDB convs
    (kaiming-normal x0.1), U(+-1/sqrt(fan_in)) on the rest (torch's default);
    one uniform and one normal draw for the whole model, cut into tensors in
    the port's order."""
    shapes = param_shapes(gen)
    sizes = [math.prod(s) for _, s, _ in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    uniform = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    normal = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    params, at = {}, 0
    for (name, shape, kaiming), size in zip(shapes, sizes):
        fan_in = math.prod(shape[1:])
        scale = 0.1 * math.sqrt(2.0 / fan_in) if kaiming else 1.0 / math.sqrt(fan_in)
        params[name] = (normal if kaiming else uniform)[at:at + size].view(shape).mul(scale)
        at += size
    return params


def f32_conv(x: torch.Tensor, w: torch.Tensor, padding: Pad, dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, None, padding=padding, dilation=dilation)


class _Fp8Conv(torch.autograd.Function):
    """``esrgan.fp8_conv``'s float8 conv (input, weight and output in e4m3,
    the incoming gradient in e5m2, per-tensor scales), with a padding per
    side and a dilation, without a bias."""

    @staticmethod
    def forward(ctx, x, w, padding, dilation):
        xq = esrgan._round8(x, torch.float8_e4m3fn, esrgan._E4M3_MAX)
        wq = esrgan._round8(w, torch.float8_e4m3fn, esrgan._E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        ctx.padding, ctx.dilation = padding, dilation
        out = F.conv2d(xq, wq, None, padding=padding, dilation=dilation)
        return esrgan._round8(out, torch.float8_e4m3fn, esrgan._E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = esrgan._round8(g, torch.float8_e5m2, esrgan._E5M2_MAX)
        kw = dict(padding=ctx.padding, dilation=ctx.dilation)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, **kw)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, **kw)
        return gx, gw, None, None


def fp8_conv(x: torch.Tensor, w: torch.Tensor, padding: Pad, dilation: int = 1) -> torch.Tensor:
    """The control's conv (:class:`_Fp8Conv`)."""
    return _Fp8Conv.apply(x, w, padding, dilation)


def rfb(x: torch.Tensor, p: Params, prefix: str, conv: Conv, lrelu: bool = True) -> torch.Tensor:
    """One receptive-field block: ``merge(branches) * 0.2 + shortcut(x)``, then LeakyReLU where ``lrelu``."""
    cout, cin = p[f"{prefix}.shortcut.weight"].shape[:2]
    convs = {name: (p[f"{prefix}.{name}.weight"], pad, dil) for name, _, pad, dil in rfb_convs(cin, cout)}

    def c(name, v):
        w, pad, dil = convs[name]
        return conv(v, w, pad, dil)

    def branch(b, last):
        h = F.relu(c(f"branch{b}.0", x))
        for k in range(2, last, 2):
            h = F.relu(c(f"branch{b}.{k}", h))
        return c(f"branch{b}.{last}", h)

    out = torch.cat([branch(1, 2), branch(2, 4), branch(3, 4), branch(4, 6)], 1)
    out = c("conv1x1", out) * 0.2 + c("shortcut", x)
    return F.leaky_relu(out, 0.2) if lrelu else out


def rfdb(x: torch.Tensor, p: Params, prefix: str, conv: Conv) -> torch.Tensor:
    """x + 0.2 * RFB5([x, h1 .. h4]), h_m = RFB_m([x, h1 .. h_{m-1}])."""
    feats = [x]
    for m in range(1, 5):
        feats.append(rfb(torch.cat(feats, 1), p, f"{prefix}.RFB{m}", conv))
    return rfb(torch.cat(feats, 1), p, f"{prefix}.RFB5", conv, lrelu=False) * 0.2 + x


def rdb(x: torch.Tensor, p: Params, prefix: str, conv: Conv) -> torch.Tensor:
    """The bias-free RDB: x + 0.2 * conv5([x, h1 .. h4]), h_k = lrelu(conv_k([x, h1 .. h_{k-1}]))."""
    feats = [x]
    for k in range(1, 5):
        feats.append(F.leaky_relu(conv(torch.cat(feats, 1), p[f"{prefix}.conv{k}.0.weight"], 1, 1), 0.2))
    return conv(torch.cat(feats, 1), p[f"{prefix}.conv5.weight"], 1, 1) * 0.2 + x


def forward(p: Params, gen: dict, lr: torch.Tensor, conv: Conv = f32_conv) -> torch.Tensor:
    """(N, in_channels, h, w) LR input -> (N, out_channels, h*s, w*s) in (-1, 1)."""
    out1 = conv(lr, p["conv1.weight"], 1, 1)
    trunk = out1
    for i in range(gen["num_rrdb_blocks"]):
        h = trunk
        for j in (1, 2, 3):
            h = rdb(h, p, f"Trunk_A.{i}.RDB{j}", conv)
        trunk = h * 0.2 + trunk
    for i in range(gen["num_rrfdb_blocks"]):
        h = trunk
        for j in (1, 2, 3):
            h = rfdb(h, p, f"Trunk_RFB.{i}.RFDB{j}", conv)
        trunk = h * 0.2 + trunk
    out = rfb(out1 + trunk, p, "RFB", conv, lrelu=False)
    for b in range(upsampling_stages(gen)):
        out = rfb(F.interpolate(out, scale_factor=2, mode="nearest"), p, f"upsampling.{6 * b + 1}", conv)
        out = F.leaky_relu(conv(out, p[f"upsampling.{6 * b + 2}.weight"], 1, 1), 0.2)
        out = rfb(F.pixel_shuffle(out, 2), p, f"upsampling.{6 * b + 5}", conv)
    out = F.leaky_relu(conv(out, p["conv3.0.weight"], 1, 1), 0.2)
    return torch.tanh(conv(out, p["conv4.0.weight"], 1, 1))


def loss_and_grads(p: Params, gen: dict, batch: Dict[str, torch.Tensor], block: int,
                   conv: Conv) -> Tuple[float, Params, torch.Tensor]:
    """The L1 loss over the whole batch, its gradient summed over blocks of
    rows, and the generator's output."""
    n = batch["hr"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    count = batch["hr"].numel()
    total, outs = 0.0, []
    for i in range(0, n, block):
        sl = slice(i, min(i + block, n))
        sr = forward(leaves, gen, batch["lr"][sl], conv)
        loss = (sr - batch["hr"][sl]).abs().sum() / count
        loss.backward()
        total += loss.item()
        outs.append(sr.detach())
    return total, {k: v.grad for k, v in leaves.items()}, torch.cat(outs)


def run_steps(p0: Params, gen: dict, tiles: Dict[str, np.ndarray], traffic: dict, seed: int, steps: int,
              device: torch.device, conv: Conv, block: int = 32) -> Dict[str, object]:
    """``steps`` steps from p0 over the first batches of epoch 0 (as
    ``train.run_steps``): each step's loss, the first step's generator output
    and gradient, and the parameters after the last."""
    bs, scale = traffic["batch_size"], traffic["scale"]
    n = len(tiles["hr"])
    opt, sched = traffic["optimizer"], traffic["schedule"]
    total = (n // bs) * traffic["epochs"]
    order = train.epoch_order(n, seed, 0)
    p, state = dict(p0), {}
    losses: List[float] = []
    first = first_out = None
    with esrgan.exact_matmul():
        for t in range(steps):
            batch = train.batch_rows(tiles, order[t * bs:(t + 1) * bs], seed, t, scale, device,
                                     traffic["transforms"])
            loss, grads, out = loss_and_grads(p, gen, batch, block, conv)
            losses.append(loss)
            if first is None:
                first, first_out = grads, out
            lr, beta1 = train.one_cycle(t, total, opt["lr"], **sched)
            p = train.adamw(p, grads, state, t + 1, lr, beta1, opt["betas"][1], opt["eps"], opt["weight_decay"])
            del batch, grads
    return {"losses": losses, "first_grads": first, "first_out": first_out, "params": p}
