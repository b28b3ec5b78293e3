# -*- coding: utf-8 -*-
"""Build the package's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel lives in ``climsr_tpu_torch/csrc/`` as a ``.cu`` file with a plain
C entry point. At first use it is compiled for Hopper (``sm_90a``) into a
shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of its sources and flags, so a changed source
rebuilds and an unchanged one is reused. Several libraries build in parallel
(one ``nvcc`` each, started together). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where ``lib<name>`` built from ``sources`` (file names in csrc/) lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.encode())
        digest.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(libraries: Dict[str, Sequence[str]]) -> Dict[str, Path]:
    """Compile every library that is not built yet, all ``nvcc`` runs at once.

    Returns ``{name: path}``. The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside each library as ``.log``.
    Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name, srcs) for name, srcs in libraries.items()}
    running = {}
    for name, srcs in libraries.items():
        if paths[name].is_file():
            continue
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in srcs)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp)
    failures = []
    for name, (proc, tmp) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        paths[name].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[name])  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; loaded once per process."""
    if name not in _loaded:
        path = build({name: sources})[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
