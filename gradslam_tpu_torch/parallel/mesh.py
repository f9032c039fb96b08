"""(data, map) meshes over the ranks of a ``torch.distributed`` run (PyTorch
port of gradslam_tpu.parallel.mesh).

Each rank drives one device. A :class:`Mesh` lays the world's ranks out
row-major over two axes, as ``np.reshape(ranks, (data, map_))`` does:

  - ``data``: batch-of-sequences data parallelism; each data group runs its
    slice of the batch;
  - ``map``: the map arena partitioned over its capacity (the arena is the
    big state; association and fusion shard over its slots).

The mesh keeps one process group per row (the ``map`` axis) and one per
column (the ``data`` axis). Its collective is ``all_reduce``; an axis of
one rank needs none.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..slam.mapshard import MapShard, owner_sum
from ..structures.maparena import MapState
from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "shard_map_state",
    "unshard_batch",
    "unshard_map_state",
]

AXES = ("data", "map")


class Mesh:
    """A (data, map) layout of the world's ranks; see :func:`make_mesh`.

    Attributes:
        shape: ``{"data": data, "map": map_}``.
        rank: this process's rank; it sits at ``(rank // map_, rank % map_)``.
        device: the device this rank computes on.
    """

    axis_names = AXES

    def __init__(self, data: int, map_: int, rank: int, device: torch.device, groups: dict):
        self.shape = {"data": data, "map": map_}
        self.rank = rank
        self.device = device
        self._groups = groups
        self._device_mesh = None

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        m = self.shape["map"]
        return self.rank // m if axis == "data" else self.rank % m

    def group(self, axis: Optional[str]):
        """The process group along ``axis`` through this rank (None: the
        whole world)."""
        return self._groups[axis]

    def _runs(self, axis: Optional[str]) -> bool:
        return dist.is_initialized() and (axis is None or self.shape[axis] > 1)

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place ``all_reduce`` along ``axis`` (None: every rank)."""
        if self._runs(axis):
            dist.all_reduce(x, op=op, group=self.group(axis))
        return x

    def assemble(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Owner-placed sum: ``x`` holds this rank's values at their global
        positions and zeros elsewhere; every rank gets the owners' bits
        (floats are summed as their integer bits)."""
        return owner_sum(x, self.group(axis)) if self._runs(axis) else x

    def device_mesh(self):
        """This mesh as a ``torch.distributed`` ``DeviceMesh`` with dims
        ('data', 'map'), for ``DTensor``s such as the sharded checkpoint's.

        Built once, from the mesh's own groups, so it opens no group of
        another backend (ranks that share a card stay on gloo); an axis of
        one rank gets a group of this rank alone, made without the others.
        """
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            groups = [
                self._groups[axis] if self.shape[axis] > 1
                else dist.new_group([self.rank], use_local_synchronization=True)
                for axis in AXES
            ]
            ranks = torch.arange(self.shape["data"] * self.shape["map"]).reshape(self.shape["data"], self.shape["map"])
            self._device_mesh = DeviceMesh.from_group(groups, self.device.type, mesh=ranks, mesh_dim_names=AXES)
        return self._device_mesh

    def map_shard(self, capacity: int):
        """This rank's :class:`~gradslam_tpu_torch.slam.mapshard.MapShard`
        of a ``capacity``-row arena partitioned over the map axis."""
        return MapShard(self.group("map"), self.index("map"), self.shape["map"], capacity)

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, map={self.shape['map']}, rank={self.rank}, device={self.device})"


def make_mesh(data: Optional[int] = None, map_: Optional[int] = None, device=None) -> Mesh:
    """Creates a (data, map) mesh over the world's ranks.

    Defaults to every rank on the data axis. ``data * map_`` must equal the
    world size (1 without an initialized process group). Every rank calls
    it, in the same order as its other group creations: it makes the
    groups of each row and column.

    Args:
        device: the device this rank computes on; default ``"cuda"``.
    """
    init = dist.is_initialized()
    n = dist.get_world_size() if init else 1
    if data is None and map_ is None:
        data, map_ = n, 1
    elif data is None:
        data = n // map_
    elif map_ is None:
        map_ = n // data
    if data * map_ != n:
        raise ValueError(f"mesh shape data={data} x map={map_} != world size {n}")
    rank = dist.get_rank() if init else 0
    groups = {None: dist.group.WORLD if init else None, "data": None, "map": None}
    rows = [[i * map_ + j for j in range(map_)] for i in range(data)]
    cols = [[i * map_ + j for i in range(data)] for j in range(map_)]
    for axis, lines in (("map", rows), ("data", cols)):
        if len(lines[0]) == 1 or not init:
            continue
        for ranks in lines:
            g = dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(data, map_, rank, resolve_device(device), groups)


def _map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, MapState):
        return MapState(fn(tree.data), fn(tree.num_points))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x) for x in tree)
    return fn(torch.as_tensor(tree))


def _batch_slice(mesh: Mesh, B: int) -> slice:
    d = mesh.shape["data"]
    if B % d:
        raise ValueError(f"batch {B} is not a multiple of the data axis {d}")
    b = B // d
    i = mesh.index("data")
    return slice(i * b, (i + 1) * b)


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of the leading (batch) axis of every tensor in a
    tree (tuples, lists, map states, None), on the mesh's device."""
    return _map_tree(lambda x: x[_batch_slice(mesh, x.shape[0])].to(mesh.device), tree)


def shard_map_state(mesh: Mesh, map_state: MapState) -> MapState:
    """This rank's (B/data, CAP/map, C) shard of a global arena: the batch
    over 'data', the capacity over 'map'. ``num_points`` stays global."""
    bs = _batch_slice(mesh, map_state.data.shape[0])
    shard = mesh.map_shard(map_state.capacity)
    rows = slice(shard.offset, shard.offset + shard.rows)
    return MapState(map_state.data[bs, rows].to(mesh.device), map_state.num_points[bs].to(mesh.device))


def unshard_batch(mesh: Mesh, tree):
    """The global batch on every rank from each data group's slice (the
    inverse of :func:`shard_batch`): one owner-placed sum over 'data'."""

    def one(x):
        d = mesh.shape["data"]
        out = x.new_zeros((x.shape[0] * d,) + x.shape[1:])
        out[_batch_slice(mesh, out.shape[0])] = x
        return mesh.assemble(out, "data")

    return _map_tree(one, tree)


def unshard_map_state(mesh: Mesh, map_state: MapState) -> MapState:
    """The global (B, CAP, C) arena on every rank from the ranks' shards (the
    inverse of :func:`shard_map_state`): one owner-placed sum over the
    whole mesh, the counts over 'data'."""
    b, rows, C = map_state.data.shape
    d, m = mesh.shape["data"], mesh.shape["map"]
    data = map_state.data.new_zeros((b * d, rows * m, C))
    bs = _batch_slice(mesh, b * d)
    j = mesh.index("map")
    data[bs, j * rows : (j + 1) * rows] = map_state.data
    return MapState(mesh.assemble(data), unshard_batch(mesh, map_state.num_points))
