"""ctypes binding for the native (C++) batch frame loader.

``native/loader.cpp`` decodes PNG and JPEG frames on a thread pool, resizes
them and scales depth: the host side of the input pipeline. This module
compiles it with ``g++`` (the flags of ``native/Makefile``) into
``gradslam_tpu_torch/_build/`` at first use, beside the CUDA builds; the
source is only read. Where the toolchain or libpng/libjpeg's headers are
missing, :func:`native_available` is False and the loaders decode in
Python instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

from ..utils.cuda_build import BUILD_DIR

__all__ = ["native_available", "load_color_batch", "load_depth_batch", "library_path"]

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lpthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the library built from ``native/loader.cpp`` lives (the name
    carries a hash of the source and the flags)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgsloader_{digest}.so"


def _build() -> Optional[pathlib.Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", tmp, *LIBS],
            check=True, capture_output=True, timeout=240,
        )
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        pathlib.Path(tmp).unlink(missing_ok=True)
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.gs_load_color_batch.restype = ctypes.c_int
        lib.gs_load_color_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
        ]
        lib.gs_load_depth_batch.restype = ctypes.c_int
        lib.gs_load_depth_batch.argtypes = lib.gs_load_color_batch.argtypes
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native loader library is (or can be) built."""
    return _load() is not None


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def load_color_batch(
    paths: Sequence[str], height: int, width: int, normalize: bool = False
) -> Optional[np.ndarray]:
    """Loads color images into (N, H, W, 3) float32 via the native loader.

    Returns None when the native library is unavailable (callers fall back
    to the Python path). Raises on decode failure.
    """
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 3), dtype=np.float32)
    rc = lib.gs_load_color_batch(
        _paths_array(paths),
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height,
        width,
        1.0 / 255.0 if normalize else 1.0,
    )
    if rc:
        raise IOError(f"native loader failed on {paths[rc - 1]}")
    return out


def load_depth_batch(
    paths: Sequence[str], height: int, width: int, depth_scale: float
) -> Optional[np.ndarray]:
    """Loads 16-bit depth PNGs into (N, H, W, 1) float32 / depth_scale."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width), dtype=np.float32)
    rc = lib.gs_load_depth_batch(
        _paths_array(paths),
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height,
        width,
        1.0 / depth_scale,
    )
    if rc:
        raise IOError(f"native loader failed on {paths[rc - 1]}")
    return out[..., None]
