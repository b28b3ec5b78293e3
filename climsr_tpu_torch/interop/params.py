# -*- coding: utf-8 -*-
"""Weights carried into the port: JAX param trees and reference checkpoints.

- :func:`state_dict_from_flax` turns a ``climsr_tpu`` param tree (nested dicts
  of numpy arrays, flax HWIO kernels) into the port's ``state_dict`` (OIHW),
  for every generator family (``srcnn``, ``esrgan``, ``rcan``, ``drln``,
  ``rfb_esrgan``). The key mappings are those of
  ``climsr_tpu/interop/torch_import.py:94-216`` (copied, not imported); a
  leaf without ``bias`` (RFB-ESRGAN's convs) gives a ``weight`` alone.
- :func:`discriminator_state_dict_from_flax`,
  :func:`rfb_discriminator_state_dict_from_flax` and
  :func:`vgg_state_dict_from_flax` do the same for the ESRGAN and RFB-ESRGAN
  discriminators (with their BatchNorm statistics) and the VGG19 features,
  with the mappings of ``torch_import.py:219-245`` and
  ``climsr_tpu/models/vgg.py:26-35`` (copied).
- :func:`load_generator_checkpoint` and :func:`load_discriminator_checkpoint`
  read a reference PyTorch-Lightning ``.ckpt`` (or a plain ``state_dict``
  file) and strip the ``generator.`` / ``discriminator.`` prefix, so the result
  loads into the port's modules with ``strict=True``. For ``drln`` the
  reference's dead compressor ``c4.body.*`` (never applied in its forward,
  and not made by the port, as by the JAX package) is dropped.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

GENERATOR_PREFIX = "generator."
DISCRIMINATOR_PREFIX = "discriminator."

Spec = List[Tuple[str, str]]  # (torch module prefix, flax path of its Conv_0)


def _srcnn_spec(torch_prefix: str = "", flax_prefix: str = "") -> Spec:
    return [(f"{torch_prefix}conv{i}", f"{flax_prefix}conv{i}") for i in (1, 2, 3)]


def _count(params: dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in params:
        n += 1
    return n


def _esrgan_spec(params: dict) -> Spec:
    spec: Spec = [("conv_first", "conv_first")]
    for i in range(_count(params, "RRDB_trunk_{}")):
        for j in (1, 2, 3):
            for k in range(1, 6):
                spec.append((f"RRDB_trunk.{i}.RDB{j}.conv{k}", f"RRDB_trunk_{i}/RDB{j}/conv{k}"))
    spec += [("trunk_conv", "trunk_conv"), ("upconv1", "upconv1")]
    if "upconv2" in params:  # scale 4 only
        spec.append(("upconv2", "upconv2"))
    spec += [("HRconv", "HRconv"), ("conv_last", "conv_last")]
    return spec + _srcnn_spec("srcnn.", "srcnn/")


def _rcan_spec(params: dict) -> Spec:
    n_groups = _count(params, "group_{}")
    n_blocks = _count(params["group_0"], "rcab_{}")
    spec: Spec = [("head.0", "head")]
    for g in range(n_groups):
        for b in range(n_blocks):
            base, fl = f"body.{g}.body.{b}.body", f"group_{g}/rcab_{b}"
            spec += [(f"{base}.0", f"{fl}/conv1"), (f"{base}.2", f"{fl}/conv2"),
                     (f"{base}.3.conv_du.0", f"{fl}/ca/du1"), (f"{base}.3.conv_du.2", f"{fl}/ca/du2")]
        spec.append((f"body.{g}.body.{n_blocks}", f"group_{g}/conv_tail"))
    spec.append((f"body.{n_groups}", "body_tail"))
    # the Upsampler's convs at even indices (PixelShuffle between)
    spec += [(f"tail.0.{2 * k}", f"upsampler/conv_{k}") for k in range(_count(params["upsampler"], "conv_{}"))]
    spec.append(("tail.1", "tail_conv"))
    return spec + _srcnn_spec("srcnn.", "srcnn/")


def _drln_spec(params: dict) -> Spec:
    spec: Spec = [("head", "head")]
    for i in range(1, 21):
        for j in (1, 2, 3):
            spec += [(f"b{i}.r{j}.body.0", f"b{i}/r{j}/conv1"), (f"b{i}.r{j}.body.2", f"b{i}/r{j}/conv2")]
        spec += [(f"b{i}.g.body.0", f"b{i}/g/TorchConv_0"), (f"b{i}.ca.c1.body.0", f"b{i}/ca/c1/TorchConv_0"),
                 (f"b{i}.ca.c4.body.0", f"b{i}/ca/c4")]
        if i != 4:  # the dead compressor c4 has no module
            spec.append((f"c{i}.body.0", f"c{i}/TorchConv_0"))
    # [conv, ReLU, PixelShuffle] per 2x stage
    spec += [(f"upsample.up.body.{3 * k}", f"upsample/conv_{k}") for k in range(_count(params["upsample"], "conv_{}"))]
    return spec + [("tail", "tail")]


def _rfb_block_spec(torch_prefix: str, flax_prefix: str) -> Spec:
    spec: Spec = [(f"{torch_prefix}.shortcut", f"{flax_prefix}/shortcut")]
    for branch, n_convs in ((1, 2), (2, 3), (3, 3), (4, 4)):  # convs at even Sequential indices
        spec += [(f"{torch_prefix}.branch{branch}.{2 * k}", f"{flax_prefix}/b{branch}_{k}") for k in range(n_convs)]
    return spec + [(f"{torch_prefix}.conv1x1", f"{flax_prefix}/conv1x1")]


def _rfb_esrgan_spec(params: dict) -> Spec:
    spec: Spec = [("conv1", "conv1")]
    for i in range(_count(params, "trunk_a_{}")):
        for j in (1, 2, 3):
            spec += [(f"Trunk_A.{i}.RDB{j}.conv{k}.0", f"trunk_a_{i}/RDB{j}/conv{k}") for k in (1, 2, 3, 4)]
            spec.append((f"Trunk_A.{i}.RDB{j}.conv5", f"trunk_a_{i}/RDB{j}/conv5"))
    for i in range(_count(params, "trunk_rfb_{}")):
        for j in (1, 2, 3):
            for m in (1, 2, 3, 4, 5):
                spec += _rfb_block_spec(f"Trunk_RFB.{i}.RFDB{j}.RFB{m}", f"trunk_rfb_{i}/RFDB{j}/RFB{m}")
    spec += _rfb_block_spec("RFB", "RFB")
    for b in range(_count(params, "up_{}_conv")):  # [Upsample, RFB, conv, LeakyReLU, PixelShuffle, RFB]
        spec += _rfb_block_spec(f"upsampling.{6 * b + 1}", f"up_{b}_rfb1")
        spec.append((f"upsampling.{6 * b + 2}", f"up_{b}_conv"))
        spec += _rfb_block_spec(f"upsampling.{6 * b + 5}", f"up_{b}_rfb2")
    return spec + [("conv3.0", "conv3"), ("conv4.0", "conv4")]


_SPECS = {
    "srcnn": lambda params: _srcnn_spec(),
    "esrgan": _esrgan_spec,
    "rcan": _rcan_spec,
    "drln": _drln_spec,
    "rfb_esrgan": _rfb_esrgan_spec,
}

# reference checkpoint keys of modules the port does not make (never applied)
_DEAD_KEYS = {"drln": ("c4.body.",)}


def _get_path(tree: dict, path: str) -> dict:
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"params tree is missing {path}")
        node = node[part]
    return node


def _kernel(params: dict, path: str) -> torch.Tensor:
    """A flax conv's HWIO kernel at ``path`` as an OIHW weight."""
    kernel = np.asarray(_get_path(params, f"{path}/Conv_0")["kernel"], np.float32)  # (kh, kw, in, out)
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


def state_dict_from_flax(generator_type: str, params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (the tree under ``"params"``) -> the port's ``state_dict``."""
    if generator_type not in _SPECS:
        raise NotImplementedError(f"no weight mapping for '{generator_type}' (supported: {sorted(_SPECS)})")
    sd: Dict[str, torch.Tensor] = {}
    for tk, fp in _SPECS[generator_type](params):
        sd[f"{tk}.weight"] = _kernel(params, fp)
        leaf = _get_path(params, f"{fp}/Conv_0")
        if "bias" in leaf:
            sd[f"{tk}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
    return sd


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: dict, stats: dict) -> None:
    """BatchNorm ``weight``/``bias`` from ``scale``/``bias``, running statistics
    from ``mean``/``var``, ``num_batches_tracked`` 0."""
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _tensor(params["scale"]), _tensor(params["bias"])
    sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = _tensor(stats["mean"]), _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _dense(sd: Dict[str, torch.Tensor], prefix: str, params: dict, path: str) -> None:
    leaf = _get_path(params, f"{path}/Dense_0")
    sd[f"{prefix}.weight"] = _tensor(np.asarray(leaf["kernel"]).T)
    sd[f"{prefix}.bias"] = _tensor(leaf["bias"])


def discriminator_state_dict_from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``Discriminator``'s ``params`` and ``batch_stats`` -> the port's
    ``state_dict`` (``feature_extraction.*``, ``classification.*``; BatchNorm
    ``weight``/``bias`` from ``scale``/``bias``, running statistics from
    ``mean``/``var``, ``num_batches_tracked`` 0)."""
    n = _count(params, "block{}_bn")
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, path: str) -> None:
        sd[f"{prefix}.weight"] = _kernel(params, path)
        sd[f"{prefix}.bias"] = _tensor(_get_path(params, f"{path}/Conv_0")["bias"])

    for i in range(n):
        conv(f"feature_extraction.{7 * i + 1}", f"block{i}_conv1")
        _bn(sd, f"feature_extraction.{7 * i + 3}", params[f"block{i}_bn"], batch_stats[f"block{i}_bn"])
        conv(f"feature_extraction.{7 * i + 5}", f"block{i}_conv2")
    conv(f"feature_extraction.{7 * n}", "head_conv1")
    conv(f"feature_extraction.{7 * n + 2}", "head_conv2")
    for k, name in enumerate(("fc1", "fc2")):
        _dense(sd, f"classification.{k}", params, name)
    return sd


def rfb_discriminator_state_dict_from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``RFBESRGANDiscriminator``'s ``params`` and ``batch_stats`` ->
    the port's ``state_dict`` (``torch_import.py:219-226``): bias-free convs
    ``features.0`` and ``features.{3i-1}``, BatchNorm ``features.{3i}``
    (i = 1..7), the dense layers ``fc.0`` and ``fc.2``."""
    sd: Dict[str, torch.Tensor] = {"features.0.weight": _kernel(params, "conv0")}
    for i in range(1, 8):
        sd[f"features.{3 * i - 1}.weight"] = _kernel(params, f"conv{i}")
        _bn(sd, f"features.{3 * i}", params[f"bn{i}"], batch_stats[f"bn{i}"])
    _dense(sd, "fc.0", params, "fc1")
    _dense(sd, "fc.2", params, "fc2")
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


def load_generator_checkpoint(path: Union[str, Path], generator_type: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A reference PL ``.ckpt`` (or a plain saved ``state_dict``) -> the
    generator's ``state_dict`` on the CPU, with the ``generator.`` prefix
    stripped. A directory (an orbax checkpoint of the JAX package) raises.
    With ``generator_type="drln"`` the reference's dead ``c4.body.*`` (a
    compressor its forward never applies, which the port does not make) is
    dropped, so the rest loads with ``strict=True``."""
    sd = _read_state_dict(path)
    gen = {k[len(GENERATOR_PREFIX):]: v for k, v in sd.items() if k.startswith(GENERATOR_PREFIX)}
    if not gen and not any(k.startswith(DISCRIMINATOR_PREFIX) for k in sd):
        gen = sd  # a bare generator state_dict
    dead = _DEAD_KEYS.get(generator_type, ())
    return {k: v for k, v in gen.items() if not k.startswith(dead)}


def load_discriminator_checkpoint(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The ``discriminator.`` part of a reference PL ``.ckpt`` (the ESRGAN or
    the RFB-ESRGAN discriminator's) -> its ``state_dict`` on the CPU. Raises
    if there is none."""
    sd = _read_state_dict(path)
    disc = {k[len(DISCRIMINATOR_PREFIX):]: v for k, v in sd.items() if k.startswith(DISCRIMINATOR_PREFIX)}
    if not disc:
        raise KeyError(f"{path} holds no '{DISCRIMINATOR_PREFIX}' weights (not a GAN checkpoint)")
    return disc
