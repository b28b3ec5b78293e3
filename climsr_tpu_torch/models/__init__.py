# -*- coding: utf-8 -*-
"""Generator registry: name -> ``nn.Module``, plus generator-call dispatch.

The port of ``climsr_tpu.models``. This slice carries ESRGAN and SRCNN; the
other families are later items of ``ROADMAP.md`` and raise until they land.
Call signature (reference ``climsr/core/task.py:235-239``): ``generator(x)``
for srcnn, ``generator(x, elev, mask)`` for the fusion generators.
"""
from __future__ import annotations

import inspect
from typing import Dict, Optional

import torch
from torch import nn

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.models.esrgan import ESRGANGenerator
from climsr_tpu_torch.models.srcnn import SRCNN

GENERATORS = {
    consts.models.srcnn: SRCNN,
    consts.models.esrgan: ESRGANGenerator,
}

# families of the JAX package that this port does not carry yet
_NOT_PORTED = {
    consts.models.rcan: "ROADMAP.md, queue 1: other generators (RCAN)",
    consts.models.drln: "ROADMAP.md, queue 1: other generators (DRLN)",
    consts.models.rfb_esrgan: "ROADMAP.md, queue 1: other generators (RFB-ESRGAN)",
}

# Generators whose forward takes (x, elev, mask); the rest take (x,).
FUSION_GENERATORS = {consts.models.esrgan, consts.models.rcan}

# Generators that consume the nearest-pre-upscaled input at HR size.
PRE_UPSCALED_GENERATORS = {consts.models.srcnn}


def create_generator(
    name: str,
    dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    train: bool = False,
    **kwargs,
) -> nn.Module:
    """Build a generator by registry name from config kwargs.

    Config keys the module does not take (``use_pallas``, ``remat``, ``name``,
    ...) are dropped, as the JAX registry drops unknown fields. ``generator``
    draws torch's default init; without it the parameters are zero, to be
    loaded from a checkpoint. The module lands on ``device`` (``None`` means
    ``cuda``) in ``torch.channels_last``.

    - ``train=False`` (inference): parameters in ``dtype``, eval mode.
    - ``train=True``: float32 parameters, train mode, and ``dtype`` (default
      float32) is the compute dtype, kept as ``module.compute_dtype``: the
      inputs are cast to it (:func:`apply_generator_batch`) and every conv
      rounds its parameters to it at use, as the JAX package keeps float32
      params under a bf16 module ``dtype``.
    """
    if name in _NOT_PORTED:
        raise NotImplementedError(f"generator '{name}' is not ported yet: {_NOT_PORTED[name]}")
    if name not in GENERATORS:
        raise KeyError(f"Unknown generator '{name}'. Available: {sorted(GENERATORS)}")
    dev = resolve_device(device)
    cls = GENERATORS[name]
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: v for k, v in kwargs.items() if k in params and k != "generator"}
    model = cls(generator=generator, **kwargs)
    if train:
        model = model.to(device=dev, dtype=torch.float32, memory_format=torch.channels_last).train()
        model.compute_dtype = dtype or torch.float32
        return model
    return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()


def apply_generator(
    name: str,
    module: nn.Module,
    x: torch.Tensor,
    elevation: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch matching the reference task-layer forward (task.py:235-239)."""
    if name in FUSION_GENERATORS:
        return module(x, elevation, mask)
    return module(x)


def apply_generator_batch(
    name: str, module: nn.Module, batch: Dict[str, torch.Tensor], compute_dtype: torch.dtype
) -> torch.Tensor:
    """:func:`apply_generator` from an NCHW batch dict, the inputs cast to
    ``compute_dtype`` on the module's device in ``torch.channels_last``: the
    training tasks' one unpacking-and-cast point
    (``climsr_tpu/models/__init__.py:89-99``)."""
    dev = next(module.parameters()).device
    B = consts.batch_items

    def get(key):
        return batch[key].to(device=dev, dtype=compute_dtype).contiguous(memory_format=torch.channels_last)

    if name in FUSION_GENERATORS:
        return module(get(B.lr), get(B.elevation), get(B.mask))
    return module(get(B.lr))
