"""Profiling helpers (PyTorch port of gradslam_tpu.utils.profiling).

Thin wrappers over ``torch.profiler`` plus a host-side timer that
synchronizes the devices holding a result before it reads the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

__all__ = ["trace", "annotate", "DeviceTimer", "sync"]


def _tensors(tree):
    """The tensors among ``tree``'s leaves (nested tuples, lists, dicts,
    named tuples and dataclasses such as ``MapState``)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree=None) -> None:
    """Waits for the work producing ``tree``: synchronizes every CUDA device
    that holds one of its tensors (the current device when ``tree`` is
    None and a card is present)."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """Captures a ``torch.profiler`` trace of the host and, with a card, the
    device into ``log_dir`` (view with TensorBoard or Perfetto); yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


def annotate(name: str):
    """Named trace span (context manager) for profiler timelines."""
    return torch.profiler.record_function(name)


class DeviceTimer:
    """Walltime timer with device synchronization.

    Example:
        >>> with DeviceTimer("fusion") as t:
        ...     out = step(x)
        ...     t.sync(out)
        >>> t.elapsed
    """

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, tree):
        sync(tree)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")
        return False
