# -*- coding: utf-8 -*-
"""VGG19 feature extractor for the perceptual loss.

The counterpart of ``climsr_tpu.models.vgg`` (reference
``climsr/losses/perceptual.py:15-19``: torchvision ``vgg19().features[:35]``,
everything through conv5_4 without its ReLU). :class:`VGG19Features` keeps
torchvision's ``features`` indices (``features.0`` = conv1_1, ...,
``features.34`` = conv5_4), so a torchvision state dict loads as it is. No
ImageNet normalisation: the reference feeds the repeated grayscale raster
straight in.

Weights (:func:`load_feature_weights`), looked up where the JAX package looks
(``climsr_tpu/models/vgg.py:100-192``):

1. ``weights/vgg19_features.npz`` at the repository root (flax HWIO params
   ``conv1_1.kernel``, ``conv1_1.bias``, ...);
2. a torchvision checkpoint ``vgg19-*.pth`` in torch hub's checkpoint
   directory;
3. otherwise seeded stand-in weights (:func:`seeded_vgg19_state_dict`), drawn
   from an explicit ``torch.Generator``. They are NOT the JAX package's seeded
   stand-in (that one comes from the JAX PRNG), so logged perceptual values of
   the two packages differ on stand-in weights. Under the reference's no-grad
   perceptual term only that logged value depends on them.

A source shallower than the requested cutoff counts as missing (warned).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from climsr_tpu_torch.models.common import TorchConv

logger = logging.getLogger(__name__)

# (name, out_channels); "M" = 2x2 max pool. torchvision's vgg19.features.
_VGG19_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), "M",
]


def conv_indices(cutoff: str = "conv5_4") -> Dict[str, int]:
    """{conv name: its index in torchvision's ``features``} through ``cutoff``."""
    out, idx = {}, 0
    for item in _VGG19_CFG:
        if item == "M":
            idx += 1
            continue
        out[item[0]] = idx
        if item[0] == cutoff:
            return out
        idx += 2  # the conv and its ReLU
    raise ValueError(f"cutoff {cutoff!r} not in the VGG19 config")


class VGG19Features(nn.Module):
    """Truncated VGG19: ``features`` through the ``cutoff`` conv, pre-ReLU.
    Computes in its input's dtype (the convs round their parameters to it)."""

    def __init__(self, cutoff: str = "conv5_4"):
        super().__init__()
        indices = conv_indices(cutoff)
        layers: List[nn.Module] = []
        cin = 3
        for item in _VGG19_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            name, ch = item
            layers.append(TorchConv(cin, ch, 3, padding=1))
            cin = ch
            if name == cutoff:
                break
            layers.append(nn.ReLU())
        assert len(layers) == indices[cutoff] + 1
        self.cutoff = cutoff
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def default_weights_path() -> Path:
    return Path(__file__).resolve().parents[2] / "weights" / "vgg19_features.npz"


def state_dict_from_npz(path, cutoff: str) -> Optional[Dict[str, torch.Tensor]]:
    """The flax-layout npz cache (``conv1_1.kernel`` HWIO, ``conv1_1.bias``) as
    a ``features`` state dict through ``cutoff``; None if it stops short."""
    data = np.load(path)
    sd = {}
    for name, idx in conv_indices(cutoff).items():
        if f"{name}.kernel" not in data.files:
            return None
        sd[f"features.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(data[f"{name}.kernel"].transpose(3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(data[f"{name}.bias"]).copy())
    return sd


def _truncate(sd: Dict[str, torch.Tensor], cutoff: str) -> Optional[Dict[str, torch.Tensor]]:
    keys = [f"features.{idx}.{kind}" for idx in conv_indices(cutoff).values() for kind in ("weight", "bias")]
    if any(k not in sd for k in keys):
        return None
    return {k: sd[k].float() for k in keys}


def seeded_vgg19_state_dict(cutoff: str = "conv5_4", seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic stand-in weights through ``cutoff``: the flax default
    init's distribution (kernel normal with std 1/sqrt(fan_in), bias zero)
    drawn from ``torch.Generator().manual_seed(seed)``, layer by layer. Not
    ImageNet weights, and not the JAX package's stand-in (another PRNG)."""
    gen = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for name, idx in conv_indices(cutoff).items():
        ch = dict(c for c in _VGG19_CFG if c != "M")[name]
        sd[f"features.{idx}.weight"] = torch.randn(ch, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros(ch)
        cin = ch
    return sd


def load_feature_weights(cutoff: str = "conv5_4") -> Tuple[Dict[str, torch.Tensor], str]:
    """``(state dict through cutoff, provenance)``: ``"pretrained"`` from the
    npz cache or else the first torch hub checkpoint, ``"seeded"``
    (:func:`seeded_vgg19_state_dict`) where there is neither or the file stops
    before ``cutoff`` (warned)."""
    path = default_weights_path()
    if not path.exists():
        path = next(iter(sorted((Path(torch.hub.get_dir()) / "checkpoints").glob("vgg19-*.pth"))), None)
    if path is not None:
        if path.suffix == ".npz":
            sd = state_dict_from_npz(path, cutoff)
        else:
            sd = _truncate(torch.load(path, map_location="cpu", weights_only=True), cutoff)
        if sd is not None:
            return sd, "pretrained"
        logger.warning("VGG19 weights at %s stop before the requested cutoff %s; using the seeded stand-in",
                       path, cutoff)
    return seeded_vgg19_state_dict(cutoff), "seeded"
