"""Builds, loads and launches the port's CUDA libraries, and counts their launches.

Each ``csrc/*.cu`` file exposes plain C entry points and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``gradslam_tpu_torch/_build/``, then
loaded with ``ctypes``. The library name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.

A kernel wrapper in ``ops/`` is a :class:`CudaLibrary` (its source and its
entry points, each launch checked and counted) and checks its tensors with
:func:`check_inputs`. The first wrapper of each ``name`` registers itself in
:data:`COUNTED`, whose counts a captured graph snapshots, restores and adds to.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

__all__ = [
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "CudaLibrary", "check_inputs", "COUNTED",
    "launch_counts", "restore_launch_counts", "add_launch_counts",
]

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


# the counted kernel wrappers by name, in the order they were constructed; a
# later wrapper of a name (a test's own) leaves the registered one in place
COUNTED = {}


class CudaLibrary:
    """One ``csrc/<source>`` library: built and loaded at its first use, its
    entry points launched on the current stream.

    A subclass sets :attr:`source`, :attr:`entries` (``symbol -> argtypes``;
    every entry point returns a ``cudaError_t`` as an int) and, for a kernel
    whose launches are counted, :attr:`name`: the first wrapper constructed
    of a name registers in :data:`COUNTED`. :attr:`launches` counts the
    successful launches.
    """

    source: str
    entries: dict
    name: Optional[str] = None

    def __init__(self):
        self.launches = 0
        self._fns = None
        if self.name is not None:
            COUNTED.setdefault(self.name, self)

    def load(self):
        """Loads the library, building it first if needed: ``{symbol: entry point}``."""
        if self._fns is None:
            lib = ctypes.CDLL(str(build(self.source)))
            fns = {}
            for symbol, argtypes in self.entries.items():
                fns[symbol] = fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self._fns = fns
        return self._fns

    def invoke(self, symbol: str, device: torch.device, *args) -> None:
        """Calls entry point ``symbol`` with ``args`` and the handle of
        ``device``'s current stream, ``device`` made current only where it is
        not; raises on a non-zero ``cudaError``, else counts the launch."""
        if self._fns is None:
            self.load()
        fn = self._fns[symbol]
        switch = device.index is not None and device.index != torch.cuda.current_device()
        with torch.cuda.device(device) if switch else contextlib.nullcontext():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.source} {symbol} launch failed: cudaError {err}")
        self.launches += 1


def check_inputs(kernel: str, **inputs) -> None:
    """Checks a kernel's tensors, each ``name=(tensor, dtype, shape)`` (a None
    tensor is an input left out), in this order: all on the CUDA device of
    the first, each one's dtype (``TypeError``), its shape and its
    contiguity (``ValueError``). An int in ``shape`` is a size; a string
    names a size that is the same wherever the name appears."""
    given = {name: spec for name, spec in inputs.items() if spec[0] is not None}
    device = next(iter(given.values()))[0].device
    for name, (t, _, _) in given.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}; every input must be on one CUDA device, {device}")
    for name, (t, dtype, _) in given.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    sizes = {}
    for name, (t, _, shape) in given.items():
        fits = t.dim() == len(shape)
        for want, n in zip(shape, t.shape):
            fits = fits and n == (sizes.setdefault(want, n) if isinstance(want, str) else want)
        if not fits:
            raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    for name, (t, _, _) in given.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def launch_counts() -> dict:
    """``{name: launches}`` of every counted kernel."""
    return {name: k.launches for name, k in COUNTED.items()}


def restore_launch_counts(counts: dict) -> None:
    """Sets the counts back to a :func:`launch_counts` snapshot."""
    for name, n in counts.items():
        COUNTED[name].launches = n


def add_launch_counts(delta: dict) -> None:
    """Adds ``{name: launches}`` to the counts (a graph's replay)."""
    for name, n in delta.items():
        COUNTED[name].launches += n
