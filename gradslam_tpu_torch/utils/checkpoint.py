"""Checkpoint / resume of SLAM state (PyTorch port of
gradslam_tpu.utils.checkpoint).

All SLAM state is (map arena, poses), so a checkpoint is a direct
serialization, in the JAX package's npz layout: ``data`` (B, CAP, 12)
float32, ``num_points`` (B,) int32 and optional ``poses``. A checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..structures.maparena import MapState
from ..utils.device import resolve_device

__all__ = ["save_slam_state", "load_slam_state"]

_FIELDS = ("data", "num_points")


def _no_orbax(use_orbax: bool) -> None:
    if use_orbax:
        raise NotImplementedError(
            "orbax is the JAX package's checkpoint library; a torch.distributed checkpoint "
            "waits for ROADMAP A14 (use the npz form, use_orbax=False)"
        )


def save_slam_state(
    path: str,
    map_state: MapState,
    poses: Optional[torch.Tensor] = None,
    use_orbax: bool = False,
) -> None:
    """Saves (map arena, poses) to the npz file ``path`` (numpy appends
    ``.npz`` when missing)."""
    _no_orbax(use_orbax)
    arrays = {f: getattr(map_state, f).detach().cpu().numpy() for f in _FIELDS}
    if poses is not None:
        arrays["poses"] = torch.as_tensor(poses).detach().cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_slam_state(
    path: str, use_orbax: bool = False, device=None
) -> Tuple[MapState, Optional[torch.Tensor]]:
    """Loads (map arena, poses) saved by :func:`save_slam_state` (or by the
    JAX package's) onto ``device`` (default ``"cuda"``)."""
    _no_orbax(use_orbax)
    dev = resolve_device(device)
    with np.load(path) as data:
        ms = MapState(**{f: torch.from_numpy(data[f]).to(dev) for f in _FIELDS})
        poses = torch.from_numpy(data["poses"]).to(dev) if "poses" in data else None
    return ms, poses
