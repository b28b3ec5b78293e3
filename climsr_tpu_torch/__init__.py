# -*- coding: utf-8 -*-
"""PyTorch/CUDA port of ``climsr_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``climsr_tpu``'s module paths and public names. It imports
``torch``, ``numpy``, ``scipy`` and the standard library only: nothing of JAX
and nothing of the JAX package, which stays the reference the port is tested
against. Entry points run on the card (``device=None`` means ``cuda``) unless
the caller passes ``device="cpu"``.
"""
