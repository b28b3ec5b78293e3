"""The plain pixel-loss pre-training steps that the benchmark holds the
port's Trainer against.

Each step, as the configuration and the traffic state it: the epoch's
shuffled order of the tile set (``numpy.random.default_rng(seed + epoch)``),
the step's batch of rows, its flips and 90-degree rotations (those the
traffic turns on) drawn from ``(seed, step)`` on the batch's device and applied alike to the HR target,
the elevation and the mask, the LR input as the top-left decimation of the
augmented rasters, the generator, the L1 loss over every pixel, its
gradient, and AdamW (decoupled weight decay) with the one-cycle learning rate
and beta1 co-cycle. Written out here from those rules, in float32 with TF32
off; the gradient is summed over blocks of rows so that it fits beside
nothing else.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import esrgan

Params = Dict[str, torch.Tensor]


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def step_flags(n: int, seed: int, step: int, device: torch.device,
               transforms: Dict[str, bool]) -> Tuple[torch.Tensor, ...]:
    """(vflip, hflip, k) per sample: a uniform draw for each of the
    transforms ``v_flip``, ``h_flip`` and ``random_90_rotation`` that is on
    (an off one is never drawn and never applied), then a draw of 0..3, from
    a generator seeded by SeedSequence((seed, step)); the rotation is kept
    where its draw is under 0.5."""
    state = np.random.SeedSequence((int(seed), int(step))).generate_state(2, np.uint32)
    g = torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))
    v, h, rot = (torch.rand(n, generator=g, device=device) < 0.5 if transforms[key]
                 else torch.zeros(n, dtype=torch.bool, device=device)
                 for key in ("v_flip", "h_flip", "random_90_rotation"))
    k = torch.randint(0, 4, (n,), generator=g, device=device)
    return v, h, torch.where(rot, k, torch.zeros_like(k))


def augment(x: torch.Tensor, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per sample of (N, C, H, W): rows reversed if vflip, then columns if
    hflip, then rotated k quarter turns counter-clockwise."""
    v, h, k = (f.tolist() for f in flags)
    out = []
    for i in range(x.shape[0]):
        t = x[i]
        if v[i]:
            t = t.flip(-2)
        if h[i]:
            t = t.flip(-1)
        out.append(torch.rot90(t, k[i], dims=(-2, -1)))
    return torch.stack(out)


def one_cycle(step: int, total: int, max_lr: float, pct_start: float, div_factor: float,
              final_div_factor: float, base_momentum: float, max_momentum: float) -> Tuple[float, float]:
    """(lr, beta1) at update ``step`` (0 first) of a one-cycle schedule over
    ``total`` updates: cosine warm-up from max_lr / div_factor, then cosine
    decay to that / final_div_factor; beta1 moves the other way between
    max_momentum and base_momentum."""
    up = max(1, int(math.ceil(pct_start * total)) - 1)
    down = max(1, total - up - 1)
    initial, floor = max_lr / div_factor, max_lr / div_factor / final_div_factor
    if step <= up:
        c = 0.5 * (1.0 - math.cos(math.pi * min(step, up) / up))
        return initial + (max_lr - initial) * c, max_momentum + (base_momentum - max_momentum) * c
    pos = min(max((step - up) / down, 0.0), 1.0)
    c = 0.5 * (1.0 + math.cos(math.pi * pos))
    return floor + (max_lr - floor) * c, max_momentum + (base_momentum - max_momentum) * c


def batch_rows(tiles: Dict[str, np.ndarray], rows: np.ndarray, seed: int, step: int, scale: int,
               device: torch.device, transforms: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """The augmented batch of ``rows``: lr (N, 3, h, w), hr, elevation, mask (N, 1, H, W)."""
    raw = [torch.from_numpy(np.ascontiguousarray(tiles[k][rows])).to(device, torch.float32)[:, None]
           for k in ("hr", "elevation", "mask")]
    flags = step_flags(len(rows), seed, step, device, transforms)
    hr, elev, mask = (augment(t, flags) for t in raw)
    lr = torch.cat([t[..., ::scale, ::scale] for t in (hr, elev, mask)], 1)
    return {"lr": lr, "hr": hr, "elevation": elev, "mask": mask}


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
        sr = esrgan.forward(leaves, gen, batch["lr"][sl], batch["elevation"][sl], batch["mask"][sl], conv)
        loss = (sr - batch["hr"][sl]).abs().sum() / count
        loss.backward()
        total += loss.item()
        outs.append(sr.detach())
    return total, {k: v.grad for k, v in leaves.items()}, torch.cat(outs)


def adamw(p: Params, grads: Params, state: Dict[str, Dict[str, torch.Tensor]], t: int, lr: float, beta1: float,
          beta2: float, eps: float, weight_decay: float) -> Params:
    """One AdamW update (update number t, 1 first): decay, moments, bias-corrected step."""
    out = {}
    for k, w in p.items():
        g = grads[k]
        s = state.setdefault(k, {"m": torch.zeros_like(w), "v": torch.zeros_like(w)})
        s["m"] = beta1 * s["m"] + (1 - beta1) * g
        s["v"] = beta2 * s["v"] + (1 - beta2) * g * g
        denom = (s["v"] / (1 - beta2 ** t)).sqrt() + eps
        out[k] = w * (1 - lr * weight_decay) - (lr / (1 - beta1 ** t)) * s["m"] / denom
    return out


def run_steps(p0: Params, gen: dict, tiles: Dict[str, np.ndarray], traffic: dict, seed: int, steps: int,
              device: torch.device, conv: esrgan.Conv, block: int = 64) -> Dict[str, object]:
    """``steps`` steps from p0 over the first batches of epoch 0: each step's
    loss, the first step's generator output and gradient, and the parameters
    after the last."""
    bs, scale = traffic["batch_size"], traffic["scale"]
    n = len(tiles["hr"])
    opt, sched = traffic["optimizer"], traffic["schedule"]
    total = (n // bs) * traffic["epochs"]
    order = epoch_order(n, seed, 0)
    p, state = dict(p0), {}
    losses: List[float] = []
    first = first_out = None
    with esrgan.exact_matmul():
        for t in range(steps):
            batch = batch_rows(tiles, order[t * bs:(t + 1) * bs], seed, t, scale, device, traffic["transforms"])
            loss, grads, out = loss_and_grads(p, gen, batch, block, conv)
            losses.append(loss)
            if first is None:
                first, first_out = grads, out
            lr, beta1 = one_cycle(t, total, opt["lr"], **sched)
            p = adamw(p, grads, state, t + 1, lr, beta1, opt["betas"][1], opt["eps"], opt["weight_decay"])
            del batch, grads
    return {"losses": losses, "first_grads": first, "first_out": first_out, "params": p}


def run_gan_steps(p0: Params, d0: Params, vgg: Params, gen: dict, tiles: Dict[str, np.ndarray], traffic: dict,
                  seed: int, steps: int, device: torch.device, low: bool = False) -> Dict[str, object]:
    """``steps`` relativistic GAN steps from (p0, d0): the generator's
    sub-step (pixel L1, the perceptual term without a gradient and the
    adversarial term, weighted; an AdamW update of G under the one-cycle
    schedule), then the discriminator's on the same output, detached (an AdamW
    update of D under the same schedule). Each step's (loss_G, loss_D), the first
    step's generator output, the first step's gradients of both and both
    models' parameters after the last.
    ``low``: every conv in float8 (the control)."""
    from perfbench.reference import gan

    conv = esrgan.fp8_conv if low else esrgan.f32_conv
    bs, scale = traffic["batch_size"], traffic["scale"]
    n = len(tiles["hr"])
    w = traffic["loss_weights"]
    opt, dopt, sched = traffic["optimizer"], traffic["d_optimizer"], traffic["schedule"]
    total = (n // bs) * traffic["epochs"]
    order = epoch_order(n, seed, 0)
    p, d, gs, ds = dict(p0), dict(d0), {}, {}
    losses: List[Tuple[float, float]] = []
    first = first_out = None
    with esrgan.exact_matmul():
        for t in range(steps):
            batch = batch_rows(tiles, order[t * bs:(t + 1) * bs], seed, t, scale, device, traffic["transforms"])
            gl = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            sr = esrgan.forward(gl, gen, batch["lr"], batch["elevation"], batch["mask"], conv)
            if first_out is None:
                first_out = sr.detach().clone()
            hr = batch["hr"]
            frozen = {k: v.detach() for k, v in d.items()}
            adv = gan.g_adversarial(gan.d_forward(frozen, hr, low=low), gan.d_forward(frozen, sr, low=low))
            perceptual = torch.mean(torch.abs(gan.vgg_features(vgg, hr, low) - gan.vgg_features(vgg, sr.detach(), low)))
            loss_g = w["pixel"] * torch.mean(torch.abs(sr - hr)) + w["perceptual"] * perceptual + w["adversarial"] * adv
            loss_g.backward()
            g_grads = {k: v.grad for k, v in gl.items()}
            dl = {k: v.detach().requires_grad_(True) for k, v in d.items()}
            loss_d = gan.d_adversarial(gan.d_forward(dl, hr, low=low), gan.d_forward(dl, sr.detach(), low=low))
            loss_d.backward()
            d_grads = {k: v.grad for k, v in dl.items()}
            losses.append((loss_g.item(), loss_d.item()))
            if first is None:
                first = {**{f"G.{k}": v for k, v in g_grads.items()}, **{f"D.{k}": v for k, v in d_grads.items()}}
            lr, beta1 = one_cycle(t, total, opt["lr"], **sched)
            p = adamw(p, g_grads, gs, t + 1, lr, beta1, opt["betas"][1], opt["eps"], opt["weight_decay"])
            d = adamw(d, d_grads, ds, t + 1, lr, beta1, dopt["betas"][1], dopt["eps"], dopt["weight_decay"])
            del batch, sr, gl, dl, g_grads, d_grads
    return {"losses": losses, "first_grads": first, "first_out": first_out,
            "params": {**{f"G.{k}": v for k, v in p.items()}, **{f"D.{k}": v for k, v in d.items()}}}
