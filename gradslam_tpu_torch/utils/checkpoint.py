"""Checkpoint / resume of SLAM state (PyTorch port of
gradslam_tpu.utils.checkpoint).

All SLAM state is (map arena, poses), so a checkpoint is a direct
serialization of ``data`` (B, CAP, 12) float32, ``num_points`` (B,) int32
and optional ``poses`` (B, ...), in one of two forms:

- npz (``use_orbax=False``), the JAX package's layout: a checkpoint written
  by either package resumes in the other;
- a ``torch.distributed.checkpoint`` directory (``use_orbax=True``), the
  port's counterpart of the JAX package's orbax directory. It is
  sharding-aware: under a (data, map) :class:`~gradslam_tpu_torch.parallel.mesh.Mesh`
  every rank writes and reads only its own shard, and a checkpoint saved at
  one mesh shape loads at any other, or whole in one process. Neither
  package reads the other's directory form: the npz form is the one that
  crosses.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..structures.maparena import MapState
from ..utils.device import resolve_device

__all__ = ["save_slam_state", "load_slam_state"]

_FIELDS = ("data", "num_points")


def _placements(name: str):
    """A field's ``DTensor`` placements over the mesh's (data, map) dims:
    the arena's batch over 'data' and rows over 'map'; the counts and poses
    over 'data', the same on every map rank."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Shard(1) if name == "data" else Replicate()]


def _sharded(mesh) -> bool:
    return mesh is not None and torch.distributed.is_initialized()


def _one_process(op, state, path):
    """``dcp.save`` or ``dcp.load`` of the whole state by this process alone,
    without the warning that it assumes so: here it is asked for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        op(state, checkpoint_id=path, no_dist=True)


def save_slam_state(
    path: str,
    map_state: MapState,
    poses: Optional[torch.Tensor] = None,
    use_orbax: bool = False,
    mesh=None,
) -> None:
    """Saves (map arena, poses) to ``path``.

    Args:
        path: the npz file (numpy appends ``.npz`` when missing), or the
            directory of a ``torch.distributed.checkpoint`` with
            ``use_orbax``.
        use_orbax: write the sharding-aware directory form instead of npz.
        mesh: with ``use_orbax``, the (data, map) mesh the state is sharded
            over (torch tensors do not carry their sharding): every rank
            calls this with its (B/data, CAP/map, 12) arena shard, its
            (B/data,) counts and its (B/data, ...) poses, as
            :func:`~gradslam_tpu_torch.parallel.sharded_slam` returns them,
            and writes only those. None: this process writes the whole
            state.
    """
    if not use_orbax:
        arrays = {f: getattr(map_state, f).detach().cpu().numpy() for f in _FIELDS}
        if poses is not None:
            arrays["poses"] = torch.as_tensor(poses).detach().cpu().numpy()
        np.savez_compressed(path, **arrays)
        return
    import torch.distributed.checkpoint as dcp

    state = {f: getattr(map_state, f).detach().contiguous() for f in _FIELDS}
    if poses is not None:
        state["poses"] = torch.as_tensor(poses).detach().contiguous()
    if not _sharded(mesh):
        _one_process(dcp.save, state, path)
        return
    from torch.distributed.tensor import DTensor

    # the global shapes follow from the local ones: the shards are even
    state = {k: DTensor.from_local(x, mesh.device_mesh(), _placements(k), run_check=False) for k, x in state.items()}
    dcp.save(state, checkpoint_id=path)


def load_slam_state(
    path: str, use_orbax: bool = False, device=None, mesh=None
) -> Tuple[MapState, Optional[torch.Tensor]]:
    """Loads (map arena, poses) saved by :func:`save_slam_state` (or, in the
    npz form, by the JAX package's).

    Args:
        use_orbax: read the directory form.
        device: where the state goes without a mesh; default ``"cuda"``.
        mesh: with ``use_orbax``, a (data, map) mesh of any shape whose axes
            divide the checkpoint's batch and capacity: every rank calls
            this and gets its shard, as
            :func:`~gradslam_tpu_torch.parallel.mesh.shard_map_state` would
            cut it from the whole state (poses sliced over 'data' too), on
            the mesh's device, reading only that shard.
    """
    if not use_orbax:
        dev = resolve_device(device)
        with np.load(path) as data:
            ms = MapState(**{f: torch.from_numpy(data[f]).to(dev) for f in _FIELDS})
            poses = torch.from_numpy(data["poses"]).to(dev) if "poses" in data else None
        return ms, poses
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if not _sharded(mesh):
        dev = resolve_device(device)
        state = {k: torch.empty(v.size, dtype=v.properties.dtype, device=dev) for k, v in meta.items()}
        _one_process(dcp.load, state, path)
    else:
        from torch.distributed.tensor import DTensor

        d, m = mesh.shape["data"], mesh.shape["map"]
        B, CAP = meta["data"].size[:2]
        if B % d or CAP % m:
            raise ValueError(f"a checkpoint of batch {B} and capacity {CAP} does not split over data={d} x map={m}")
        state = {}
        for name, v in meta.items():
            size = tuple(v.size)
            local = (B // d, CAP // m) + size[2:] if name == "data" else (B // d,) + size[1:]
            x = torch.empty(local, dtype=v.properties.dtype, device=mesh.device)
            state[name] = DTensor.from_local(x, mesh.device_mesh(), _placements(name), run_check=False)
        dcp.load(state, checkpoint_id=path)
        state = {k: v.to_local() for k, v in state.items()}
    return MapState(state["data"], state["num_points"]), state.get("poses")
