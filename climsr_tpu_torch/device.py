# -*- coding: utf-8 -*-
"""Device choice for the port's entry points: the card unless asked otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA where there is none raises:
    the port never moves to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; pass device='cpu' to run on the CPU"
        )
    return dev
