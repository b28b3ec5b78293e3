# -*- coding: utf-8 -*-
"""Shared string constants and dataset schema: a copy of the ``climsr_tpu.consts``
modules the port uses, with the same names and values."""
from climsr_tpu_torch.consts import batch_items  # noqa: F401
from climsr_tpu_torch.consts import cruts  # noqa: F401
from climsr_tpu_torch.consts import datasets_and_preprocessing  # noqa: F401
from climsr_tpu_torch.consts import models  # noqa: F401
from climsr_tpu_torch.consts import stages  # noqa: F401
from climsr_tpu_torch.consts import stats  # noqa: F401
from climsr_tpu_torch.consts import training  # noqa: F401
from climsr_tpu_torch.consts import world_clim  # noqa: F401
