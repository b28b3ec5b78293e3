# -*- coding: utf-8 -*-
"""ctypes bindings for the native raster IO core (``tiffio.cpp``): the port of
``climsr_tpu.native``.

At first use ``libclimsr_io-<hash>.so`` is built with ``g++ -O3 -shared
-fPIC -std=c++17 ... -lz -lpthread`` into ``build/native/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source and
the command, so an unchanged source is reused. Nothing is built at import.

The routing is the JAX package's: a file that the native decoder declines
(a nonzero return code: big-endian, tiled, LZW, float predictor, several
bands, ...) is read by the Python codec in ``climsr_tpu_torch.io.geotiff``,
with the same result. Where the library cannot be built (no ``g++``, no
zlib headers), :func:`load_native` returns None and :func:`native_error`
says why; ``io.geotiff.READS`` counts which reader took each file.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).with_name("tiffio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LINK_FLAGS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_state = {"lib": None, "tried": False, "error": None}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libclimsr_io-{digest}.so"


def _build(path: Path) -> None:
    """Compile into a temporary file and move it in place: a concurrent build
    (another process of a pool) never loads half a library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libclimsr_io-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", tmp, *LINK_FLAGS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {out.returncode}:\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        Path(tmp).unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    lib.climsr_tiff_probe.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.climsr_tiff_probe.restype = ctypes.c_int
    lib.climsr_tiff_read_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_int32]
    lib.climsr_tiff_read_f32.restype = ctypes.c_int
    lib.climsr_nearest_resize_f32.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, f32p, ctypes.c_int32,
                                              ctypes.c_int32]
    lib.climsr_nearest_resize_f32.restype = None
    lib.climsr_tiff_read_batch_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, f32p,
                                               ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.climsr_tiff_read_batch_f32.restype = None
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None where it cannot be built."""
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            path = library_path()
            try:
                if not path.is_file():
                    _build(path)
                _state["lib"] = _bind(ctypes.CDLL(str(path)))
                logger.info("native raster IO loaded from %s", path)
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _state["error"] = str(e)
                logger.warning("native raster IO unavailable, the Python codec reads every file: %s", e)
        return _state["lib"]


def native_available() -> bool:
    return load_native() is not None


def native_error() -> Optional[str]:
    """Why the library could not be built or loaded (None when it was, or before the first try)."""
    return _state["error"]


def read_raster_native(path) -> Optional[np.ndarray]:
    """Decode a single-band TIFF via the native core; None -> use the Python codec."""
    lib = load_native()
    if lib is None:
        return None
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.climsr_tiff_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.climsr_tiff_read_f32(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  h.value, w.value)
    return out if rc == 0 else None


def nearest_resize_native(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2's ``INTER_NEAREST`` resize of a 2-D array to (dh, dw): source index
    ``floor(dst * src_size / dst_size)`` in integer arithmetic. Raises where
    the library cannot be built."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"the nearest resize needs the native library, which could not be built: "
                           f"{native_error()}")
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 2 or dh <= 0 or dw <= 0:
        raise ValueError(f"nearest resize: a 2-D source and a positive size, got {src.shape} -> ({dh}, {dw})")
    dst = np.empty((dh, dw), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.climsr_nearest_resize_f32(src.ctypes.data_as(f32p), src.shape[0], src.shape[1], dst.ctypes.data_as(f32p),
                                  dh, dw)
    return dst


def read_tiles_batch_native(paths: List[str], h: int, w: int,
                            n_threads: int = 8) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode a batch of same-shaped tiles with C++ threads (no GIL).

    Returns (tiles[n, h, w], status[n]); entries with status != 0 must be
    re-read via the Python codec.
    """
    lib = load_native()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, h, w), np.float32)
    status = np.empty((n,), np.int32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.climsr_tiff_read_batch_f32(names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, n_threads,
                                   status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status
