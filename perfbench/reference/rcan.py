"""The plain RCAN generator with its fusion head, and its pixel-loss
pre-training steps, as the benchmark's reference.

Zhang et al., "Image Super-Resolution Using Very Deep Residual Channel
Attention Networks" (ECCV 2018, arXiv:1807.02758), sections 3-4.1: a 3x3
head conv; ``n_resgroups`` residual groups, each of ``n_resblocks`` residual
channel attention blocks (RCAB: 3x3 conv, ReLU, 3x3 conv, channel attention,
plus the block's input) and a 3x3 conv, plus the group's input; a 3x3 conv
after the groups plus the head's output (the long skip); a pixel-shuffle
upsampler (a 3x3 conv to 4 x n_feats and a shuffle of 2 per factor of 2);
a 3x3 out conv. The channel attention: the mean over the frame, a 1x1 conv to
n_feats / reduction channels, ReLU, a 1x1 conv back, a sigmoid, and the
features scaled channel by channel.

Departures from the paper, as the upstream climsr model and the port run it:

- no MeanShift (the inputs are normalized tiles, not RGB images);
- 3 input channels (the climate variable, the LR elevation and the LR land
  mask) and 1 output channel;
- an SRCNN fusion head (9x9 -> 64, ReLU, 1x1 -> 32, ReLU, 5x5 -> out) over
  the output, the HR elevation and the HR mask;
- the pool's mean taken in float32 and rounded once to the compute dtype
  (here it is float32 throughout, so the rounding is nothing).

Plain PyTorch on a dict of parameters named as the port's ``state_dict``
(``head.0``, ``body.{g}.body.{b}.body.{0,2,3.conv_du.0,3.conv_du.2}``,
``body.{g}.body.{n_resblocks}``, ``body.{n_resgroups}``, ``tail.0.{2k}``,
``tail.1``, ``srcnn.*``), so that the same seeded weights load into both. It
computes in float32 with TF32 off (``esrgan.exact_matmul``), or, as the
control that must come out not correct, with every conv in float8
(``esrgan.fp8_conv``). The steps reuse ``train.py``'s epoch order, batches,
one-cycle schedule and AdamW; only the generator differs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import esrgan, train

Params = Dict[str, torch.Tensor]


def _upsampler_stages(gen: dict) -> int:
    s = gen["scaling_factor"]
    if s < 2 or s & (s - 1):
        raise ValueError(f"the reference upsamples by powers of two, not {s}")
    return s.bit_length() - 1


def param_shapes(gen: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the generator ``gen`` (n_resgroups,
    n_resblocks, n_feats, reduction, in_channels, out_channels,
    scaling_factor), in the port's order."""
    nf, cin, cout = gen["n_feats"], gen["in_channels"], gen["out_channels"]
    squeeze = nf // gen["reduction"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, o, i, k=3):
        out.append((f"{name}.weight", (o, i, k, k)))
        out.append((f"{name}.bias", (o,)))

    conv("head.0", nf, cin)
    for g in range(gen["n_resgroups"]):
        for b in range(gen["n_resblocks"]):
            pre = f"body.{g}.body.{b}.body"
            conv(f"{pre}.0", nf, nf)
            conv(f"{pre}.2", nf, nf)
            conv(f"{pre}.3.conv_du.0", squeeze, nf, 1)
            conv(f"{pre}.3.conv_du.2", nf, squeeze, 1)
        conv(f"body.{g}.body.{gen['n_resblocks']}", nf, nf)
    conv(f"body.{gen['n_resgroups']}", nf, nf)
    for k in range(_upsampler_stages(gen)):
        conv(f"tail.0.{2 * k}", 4 * nf, nf)
    conv("tail.1", cout, nf)
    conv("srcnn.conv1", 64, cout + 2, 9)
    conv("srcnn.conv2", 32, 64, 1)
    conv("srcnn.conv3", cout, 32, 5)
    return out


def seeded_params(gen: dict, seed: int, device: torch.device) -> Params:
    """Weights and biases drawn U(+-1/sqrt(fan_in)) from ``seed`` on ``device``
    in float32, by ``esrgan.seeded_params``'s rule: one draw for the whole
    model, cut into tensors in the port's order."""
    shapes = param_shapes(gen)
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    params, at, fan_in = {}, 0, 1
    for (name, shape), size in zip(shapes, sizes):
        if name.endswith(".weight"):
            fan_in = math.prod(shape[1:])
        params[name] = flat[at:at + size].view(shape).mul(1.0 / math.sqrt(fan_in))
        at += size
    return params


def channel_attention(x: torch.Tensor, p: Params, prefix: str, conv: esrgan.Conv) -> torch.Tensor:
    """x scaled per channel by sigmoid(conv_du.2(relu(conv_du.0(mean over H, W of x))))."""
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.relu(conv(s, p[f"{prefix}.conv_du.0.weight"], p[f"{prefix}.conv_du.0.bias"], 0))
    return x * torch.sigmoid(conv(s, p[f"{prefix}.conv_du.2.weight"], p[f"{prefix}.conv_du.2.bias"], 0))


def rcab(x: torch.Tensor, p: Params, prefix: str, conv: esrgan.Conv) -> torch.Tensor:
    """x + CA(conv2(relu(conv0(x))))."""
    h = F.relu(conv(x, p[f"{prefix}.0.weight"], p[f"{prefix}.0.bias"], 1))
    h = conv(h, p[f"{prefix}.2.weight"], p[f"{prefix}.2.bias"], 1)
    return channel_attention(h, p, f"{prefix}.3", conv) + x


def forward(p: Params, gen: dict, lr: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor,
            conv: esrgan.Conv = esrgan.f32_conv) -> torch.Tensor:
    """(N, in_channels, h, w) LR input and (N, 1, h*s, w*s) HR elevation and
    mask -> (N, out_channels, h*s, w*s)."""

    def c(name, v, pad=1):
        return conv(v, p[f"{name}.weight"], p[f"{name}.bias"], pad)

    groups, blocks = gen["n_resgroups"], gen["n_resblocks"]
    head = c("head.0", lr)
    x = head
    for g in range(groups):
        h = x
        for b in range(blocks):
            h = rcab(h, p, f"body.{g}.body.{b}.body", conv)
        x = c(f"body.{g}.body.{blocks}", h) + x
    x = c(f"body.{groups}", x) + head
    for k in range(_upsampler_stages(gen)):
        x = F.pixel_shuffle(c(f"tail.0.{2 * k}", x), 2)
    out = c("tail.1", x)
    h = F.relu(c("srcnn.conv1", torch.cat([out, elev, mask], 1), 4))
    h = F.relu(c("srcnn.conv2", h, 0))
    return c("srcnn.conv3", h, 2)


def loss_and_grads(p: Params, gen: dict, batch: Dict[str, torch.Tensor], block: int,
                   conv: esrgan.Conv) -> Tuple[float, Params, torch.Tensor]:
    """The L1 loss over the whole batch, its gradient summed over blocks of
    rows, and the generator's output."""
    n = batch["hr"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    count = batch["hr"].numel()
    total, outs = 0.0, []
    for i in range(0, n, block):
        sl = slice(i, min(i + block, n))
        sr = forward(leaves, gen, batch["lr"][sl], batch["elevation"][sl], batch["mask"][sl], conv)
        loss = (sr - batch["hr"][sl]).abs().sum() / count
        loss.backward()
        total += loss.item()
        outs.append(sr.detach())
    return total, {k: v.grad for k, v in leaves.items()}, torch.cat(outs)


def run_steps(p0: Params, gen: dict, tiles: Dict[str, np.ndarray], traffic: dict, seed: int, steps: int,
              device: torch.device, conv: esrgan.Conv, block: int = 32) -> Dict[str, object]:
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
