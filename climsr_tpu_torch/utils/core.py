# -*- coding: utf-8 -*-
"""Misc runtime utilities: the port of ``climsr_tpu.utils.core``.

Reference ``climsr/core/utils.py``: warnings suppression, the config
pretty-printer, the ``log_step`` timing decorator and ``finish`` logger
cleanup. The JAX module's ``enable_persistent_compilation_cache`` turns on
XLA's on-disk compile cache; the port compiles nothing through XLA (its CUDA
kernels are built once per checkout into ``build/kernels/``), so it has no
counterpart here.
"""
from __future__ import annotations

import functools
import logging
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

logger = logging.getLogger(__name__)


def extras(ignore_warnings: bool = True) -> None:
    """Apply optional run mutations controlled by config flags (utils.py:17)."""
    if ignore_warnings:
        warnings.filterwarnings("ignore")


def print_config(cfg: Dict[str, Any], fields: Optional[Sequence[str]] = None) -> str:
    """Render the composed config as an indented tree (rich-tree analogue)."""
    lines = []

    def walk(node: Any, indent: int) -> None:
        pad = "  " * indent
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, (dict, list)):
                    lines.append(f"{pad}{k}:")
                    walk(v, indent + 1)
                else:
                    lines.append(f"{pad}{k}: {v}")
        elif isinstance(node, list):
            for v in node:
                lines.append(f"{pad}- {v}")

    selected = {k: cfg[k] for k in fields} if fields else cfg
    walk(selected, 0)
    out = "\n".join(lines)
    print(out)
    return out


def log_step(prefix: str = "") -> Callable:
    """Decorator logging entry/exit wall time of a step (utils.py:78-113)."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            name = prefix or fn.__name__
            logger.info("%s: started", name)
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                logger.info("%s: finished in %.2fs", name, time.time() - t0)

        return wrapper

    return decorator


def finish(loggers: Optional[Sequence[Any]] = None) -> None:
    """Close any loggers that need explicit teardown (wandb-style, utils.py:116)."""
    for lg in loggers or []:
        close = getattr(lg, "close", None) or getattr(lg, "finish", None)
        if callable(close):
            try:
                close()
            except Exception:  # teardown is best-effort
                logger.exception("Failed to close logger %r", lg)
