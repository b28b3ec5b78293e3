# -*- coding: utf-8 -*-
"""Weights carried into the port: JAX param trees and reference checkpoints.

- :func:`state_dict_from_flax` turns a ``climsr_tpu`` param tree (nested dicts
  of numpy arrays, flax HWIO kernels) into the port's ``state_dict`` (OIHW),
  for ``esrgan`` and ``srcnn``. The key mapping is the one of
  ``climsr_tpu/interop/torch_import.py:94-113`` (copied, not imported).
- :func:`discriminator_state_dict_from_flax` and :func:`vgg_state_dict_from_flax`
  do the same for the ESRGAN discriminator (with its BatchNorm statistics) and
  the VGG19 features, with the mapping of ``torch_import.py:229-245`` and
  ``climsr_tpu/models/vgg.py:26-35`` (copied).
- :func:`load_generator_checkpoint` and :func:`load_discriminator_checkpoint`
  read a reference PyTorch-Lightning ``.ckpt`` (or a plain ``state_dict``
  file) and strip the ``generator.`` / ``discriminator.`` prefix, so the result
  loads into the port's modules with ``strict=True``.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

GENERATOR_PREFIX = "generator."
DISCRIMINATOR_PREFIX = "discriminator."

Spec = List[Tuple[str, str]]  # (torch module prefix, flax path of its Conv_0)


def _srcnn_spec(torch_prefix: str = "", flax_prefix: str = "") -> Spec:
    return [(f"{torch_prefix}conv{i}", f"{flax_prefix}conv{i}") for i in (1, 2, 3)]


def _esrgan_spec(params: dict) -> Spec:
    nb = 0
    while f"RRDB_trunk_{nb}" in params:
        nb += 1
    spec: Spec = [("conv_first", "conv_first")]
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                spec.append((f"RRDB_trunk.{i}.RDB{j}.conv{k}", f"RRDB_trunk_{i}/RDB{j}/conv{k}"))
    spec += [("trunk_conv", "trunk_conv"), ("upconv1", "upconv1")]
    if "upconv2" in params:  # scale 4 only
        spec.append(("upconv2", "upconv2"))
    spec += [("HRconv", "HRconv"), ("conv_last", "conv_last")]
    return spec + _srcnn_spec("srcnn.", "srcnn/")


_SPECS = {"esrgan": _esrgan_spec, "srcnn": lambda params: _srcnn_spec()}


def _get_path(tree: dict, path: str) -> dict:
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"params tree is missing {path}")
        node = node[part]
    return node


def state_dict_from_flax(generator_type: str, params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (the tree under ``"params"``) -> the port's ``state_dict``."""
    if generator_type not in _SPECS:
        raise NotImplementedError(f"no weight mapping for '{generator_type}' (supported: {sorted(_SPECS)})")
    sd: Dict[str, torch.Tensor] = {}
    for tk, fp in _SPECS[generator_type](params):
        leaf = _get_path(params, f"{fp}/Conv_0")
        kernel = np.asarray(leaf["kernel"], np.float32)  # (kh, kw, in, out)
        sd[f"{tk}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        if "bias" in leaf:
            sd[f"{tk}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
    return sd


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def discriminator_state_dict_from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``Discriminator``'s ``params`` and ``batch_stats`` -> the port's
    ``state_dict`` (``feature_extraction.*``, ``classification.*``; BatchNorm
    ``weight``/``bias`` from ``scale``/``bias``, running statistics from
    ``mean``/``var``, ``num_batches_tracked`` 0)."""
    n = 0
    while f"block{n}_bn" in params:
        n += 1
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, path: str) -> None:
        leaf = _get_path(params, f"{path}/Conv_0")
        sd[f"{prefix}.weight"] = _tensor(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{prefix}.bias"] = _tensor(leaf["bias"])

    for i in range(n):
        conv(f"feature_extraction.{7 * i + 1}", f"block{i}_conv1")
        bn, stats, prefix = params[f"block{i}_bn"], batch_stats[f"block{i}_bn"], f"feature_extraction.{7 * i + 3}"
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _tensor(bn["scale"]), _tensor(bn["bias"])
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = _tensor(stats["mean"]), _tensor(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        conv(f"feature_extraction.{7 * i + 5}", f"block{i}_conv2")
    conv(f"feature_extraction.{7 * n}", "head_conv1")
    conv(f"feature_extraction.{7 * n + 2}", "head_conv2")
    for k, name in enumerate(("fc1", "fc2")):
        leaf = _get_path(params, f"{name}/Dense_0")
        sd[f"classification.{k}.weight"] = _tensor(np.asarray(leaf["kernel"]).T)
        sd[f"classification.{k}.bias"] = _tensor(leaf["bias"])
    return sd


def vgg_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG19Features`` ``params`` (``conv1_1``: kernel HWIO, bias,
    ...) -> the port's ``features.{i}`` state dict, at torchvision's indices."""
    from climsr_tpu_torch.models.vgg import conv_indices

    sd: Dict[str, torch.Tensor] = {}
    for name, idx in conv_indices().items():
        if name not in params:
            break  # a truncated stack
        sd[f"features.{idx}.weight"] = _tensor(np.asarray(params[name]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"features.{idx}.bias"] = _tensor(params[name]["bias"])
    return sd


def _read_state_dict(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The tensors of a PL ``.ckpt`` or a saved ``state_dict``, on the CPU."""
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{p} is a directory (an orbax checkpoint); the port reads PyTorch checkpoint files only. "
            "Reading orbax checkpoints needs tensorstore and JAX and is left out of the port "
            "(ROADMAP.md, queue 1, item 12); carry JAX params over with state_dict_from_flax"
        )
    try:
        ckpt = torch.load(p, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # PL checkpoints pickle hyperparameters (custom classes) beside the
        # weights; only a full unpickle reads those. Load trusted files only.
        logger.warning("%s holds more than tensors; unpickling it in full", p)
        ckpt = torch.load(p, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_generator_checkpoint(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A reference PL ``.ckpt`` (or a plain saved ``state_dict``) -> the
    generator's ``state_dict`` on the CPU, with the ``generator.`` prefix
    stripped. A directory (an orbax checkpoint of the JAX package) raises."""
    sd = _read_state_dict(path)
    gen = {k[len(GENERATOR_PREFIX):]: v for k, v in sd.items() if k.startswith(GENERATOR_PREFIX)}
    if not gen and not any(k.startswith(DISCRIMINATOR_PREFIX) for k in sd):
        gen = sd  # a bare generator state_dict
    return gen


def load_discriminator_checkpoint(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The ``discriminator.`` part of a reference PL ``.ckpt`` -> the
    discriminator's ``state_dict`` on the CPU. Raises if there is none."""
    sd = _read_state_dict(path)
    disc = {k[len(DISCRIMINATOR_PREFIX):]: v for k, v in sd.items() if k.startswith(DISCRIMINATOR_PREFIX)}
    if not disc:
        raise KeyError(f"{path} holds no '{DISCRIMINATOR_PREFIX}' weights (not a GAN checkpoint)")
    return disc
