"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exposes a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``gradslam_tpu_torch/_build/``, then
loaded with ``ctypes``. The library name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build"]

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels need the CUDA toolkit to build"
    )


def library_path(source: str) -> pathlib.Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> pathlib.Path:
    """Builds ``csrc/<source>`` if needed and returns the library's path.

    The library is written under a temporary name and renamed into place,
    so a concurrent reader never sees half a file.
    """
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        pathlib.Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {out.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out
