# -*- coding: utf-8 -*-
"""Measurement scripts of the port, run as ``python -m climsr_tpu_torch.scripts.<name>``."""
