"""The plain relativistic GAN step's other models: the ESRGAN discriminator
and the truncated VGG19 of the perceptual term, with the step's losses.

As the upstream climsr task (``climsr/task/pl_gan.py``) and model
(``climsr/models/discriminator.py``) define them: the discriminator is four
blocks of [reflect-pad 1, 3x3 conv, LeakyReLU 0.01, BatchNorm on the batch's
statistics, reflect-pad 1, 3x3 conv of stride 2, LeakyReLU 0.01] with the
width doubling from 64, then two unpadded 3x3 convs with LeakyReLU 0.2
between, flatten, Linear(-> 100), Linear(-> 1); VGG19's features through
conv5_4 (before its ReLU) read the one-channel raster repeated to three, and
the perceptual term is the L1 distance of the features, without a gradient.
The relativistic losses centre each score on the other side's batch mean; the
generator's loss takes the swapped labels. Parameters are dicts named as the
port's ``state_dict`` s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import esrgan

VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512]


def d_shapes(hr_size: int, cin: int = 1, width: int = 64, blocks: int = 4) -> List[Tuple[str, Tuple[int, ...]]]:
    out: List[Tuple[str, Tuple[int, ...]]] = []
    side, c, f = hr_size, cin, width
    for i in range(blocks):
        out += [(f"feature_extraction.{7 * i + 1}.weight", (f, c, 3, 3)), (f"feature_extraction.{7 * i + 1}.bias", (f,)),
                (f"feature_extraction.{7 * i + 3}.weight", (f,)), (f"feature_extraction.{7 * i + 3}.bias", (f,)),
                (f"feature_extraction.{7 * i + 5}.weight", (f, f, 3, 3)), (f"feature_extraction.{7 * i + 5}.bias", (f,))]
        side = (side - 1) // 2 + 1
        c, f = f, 2 * f
    for j in (7 * blocks, 7 * blocks + 2):
        out += [(f"feature_extraction.{j}.weight", (c, c, 3, 3)), (f"feature_extraction.{j}.bias", (c,))]
    side -= 4
    out += [("classification.0.weight", (100, c * side * side)), ("classification.0.bias", (100,)),
            ("classification.1.weight", (1, 100)), ("classification.1.bias", (1,))]
    return out


def seeded_d(hr_size: int, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Convs and linears U(+-1/sqrt(fan_in)), BatchNorm scale 1 and shift 0, from one draw."""
    shapes = d_shapes(hr_size)
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2).sub_(1)
    p, at, fan_in = {}, 0, 1
    for (name, shape), size in zip(shapes, sizes):
        if _is_bn(name):
            p[name] = (torch.ones if name.endswith(".weight") else torch.zeros)(shape, device=device)
        else:
            if name.endswith(".weight"):
                fan_in = math.prod(shape[1:])
            p[name] = flat[at:at + size].view(shape) / math.sqrt(fan_in)
        at += size
    return p


def _is_bn(name: str) -> bool:
    parts = name.split(".")
    return parts[0] == "feature_extraction" and int(parts[1]) % 7 == 3


def d_buffers(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The BatchNorm buffers a fresh discriminator holds (its state_dict's rest)."""
    out = {}
    for name, t in p.items():
        if _is_bn(name) and name.endswith(".weight"):
            base = name[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros_like(t)
            out[f"{base}.running_var"] = torch.ones_like(t)
            out[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=t.device)
    return out


def d_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, blocks: int = 4, low: bool = False) -> torch.Tensor:
    """Logits (N, 1) of x (N, 1, H, H), BatchNorm on the batch (biased variance, eps 1e-5)."""
    q = esrgan._fp8 if low else (lambda t: t)
    conv2d = esrgan.fp8_conv if low else (lambda v, w, b, padding, stride: F.conv2d(v, w, b, stride, padding))

    def conv(v, i, stride=1, pad=True):
        v = F.pad(v, (1, 1, 1, 1), mode="reflect") if pad else v
        return conv2d(v, p[f"feature_extraction.{i}.weight"], p[f"feature_extraction.{i}.bias"], 0, stride)

    for b in range(blocks):
        x = F.leaky_relu(conv(x, 7 * b + 1), 0.01)
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5)
        x = x * p[f"feature_extraction.{7 * b + 3}.weight"].view(1, -1, 1, 1) + \
            p[f"feature_extraction.{7 * b + 3}.bias"].view(1, -1, 1, 1)
        x = F.leaky_relu(conv(x, 7 * b + 5, stride=2), 0.01)
    x = F.leaky_relu(conv(x, 7 * blocks, pad=False), 0.2)
    x = conv(x, 7 * blocks + 2, pad=False).flatten(1)
    x = F.linear(q(x), q(p["classification.0.weight"]), p["classification.0.bias"])
    return F.linear(q(x), q(p["classification.1.weight"]), p["classification.1.bias"])


def vgg_shapes() -> List[Tuple[str, Tuple[int, ...]]]:
    """torchvision's ``features`` indices through conv5_4."""
    out, idx, cin = [], 0, 3
    for item in VGG19:
        if item == "M":
            idx += 1
            continue
        out += [(f"features.{idx}.weight", (item, cin, 3, 3)), (f"features.{idx}.bias", (item,))]
        cin, idx = item, idx + 2
    return out


def seeded_vgg(seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The stand-in weights' distribution (normal over sqrt(fan_in), zero
    biases), from one draw; no ImageNet file is in the repository."""
    shapes = [s for s in vgg_shapes() if s[0].endswith(".weight")]
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed) + 2)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    p, at = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        p[name] = flat[at:at + size].view(shape) / math.sqrt(math.prod(shape[1:]))
        p[name[: -len("weight")] + "bias"] = torch.zeros(shape[0], device=device)
        at += size
    return p


@torch.no_grad()
def vgg_features(p: Dict[str, torch.Tensor], x: torch.Tensor, low: bool = False) -> torch.Tensor:
    q = esrgan._fp8 if low else (lambda t: t)
    x = x.repeat(1, 3, 1, 1)
    idx, last = 0, len([i for i in VGG19 if i != "M"])
    n = 0
    for item in VGG19:
        if item == "M":
            x, idx = F.max_pool2d(x, 2), idx + 1
            continue
        x = F.conv2d(q(x), q(p[f"features.{idx}.weight"]), p[f"features.{idx}.bias"], padding=1)
        n += 1
        if n < last:
            x = F.relu(x)
        idx += 2
    return x


def _bce(logits: torch.Tensor, label: float) -> torch.Tensor:
    return -torch.mean(label * F.logsigmoid(logits) + (1.0 - label) * F.logsigmoid(-logits))


def g_adversarial(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return (_bce(fake - real.mean(), 1.0) + _bce(real - fake.mean(), 0.0)) / 2


def d_adversarial(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return (_bce(fake - real.mean(), 0.0) + _bce(real - fake.mean(), 1.0)) / 2
