"""Sharded SLAM over a (data, map) mesh and differentiable SLAM training
(PyTorch port of gradslam_tpu.parallel.sharded).

:func:`sharded_slam` runs the batch sharded over the mesh's 'data' axis and
the map arena partitioned over its 'map' axis: each rank holds a
(B/data, CAP/map, 12) shard of the arena and nothing larger. Under
``map > 1`` the ranks of a map group run the odometry on the same assembled
candidates and select the fusion winners per rank and across the group
(:mod:`gradslam_tpu_torch.slam.mapshard`); every cross-rank step is an
``all_reduce`` (an owner-placed sum or a min), so the result is that of one
device, on every :class:`SLAMOptions` mapping path.

The end-to-end stretch goal: optimize depth-calibration parameters by
backpropagating a trajectory loss through the whole SLAM run (odometry and
fusion), one device (:func:`slam_loss`) or over the mesh
(:func:`sharded_train_step`). Neither kernel of the forward has a backward:
the KNN outputs are detached and the fusion winners are integers, so
autograd differentiates the gathers, solves and merges around them, and,
under a map axis, the owner-placed sums, whose gradient is the sum of the
ranks' cotangents.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..slam.icpslam import SLAMOptions, slam_sequence
from ..utils.device import resolve_device
from .mesh import Mesh, shard_batch

__all__ = [
    "DepthCalibParams",
    "slam_loss",
    "depth_calib_from_numpy",
    "sharded_slam",
    "sharded_train_step",
]

class DepthCalibParams(nn.Module):
    """Differentiable sensor-calibration parameters: the observed depth
    becomes ``depth * scale + bias`` where it is valid (``depth > 0``).

    Args:
        scale, bias: initial values (default 1 and 0, the JAX package's
            ``DepthCalibParams.init()``), float32 parameters.
        device: default ``"cuda"``.
    """

    def __init__(self, scale: float = 1.0, bias: float = 0.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.tensor(bias, dtype=torch.float32, device=dev))

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        return depth * self.scale + self.bias * (depth > 0)


def slam_loss(
    params: DepthCalibParams,
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    gt_poses: torch.Tensor,
    opts: SLAMOptions,
    capacity: int,
    shard=None,
) -> torch.Tensor:
    """Trajectory loss after applying depth calibration: the mean squared
    position error of the recovered (B, L) trajectory against ``gt_poses``,
    differentiable end to end through odometry and fusion. ``shard``: as in
    :func:`slam_sequence`; the loss is then the same on every rank."""
    _, poses = slam_sequence(rgb_seq, params(depth_seq), intrinsics, None, opts, capacity, shard=shard)
    return ((poses[..., :3, 3] - gt_poses[..., :3, 3]) ** 2).mean()


def depth_calib_from_numpy(scale, bias, device=None) -> DepthCalibParams:
    """A :class:`DepthCalibParams` from the JAX package's
    ``DepthCalibParams`` fields as numpy scalars."""
    return DepthCalibParams(
        float(np.float32(np.asarray(scale))), float(np.float32(np.asarray(bias))), device=device
    )


def sharded_slam(mesh: Mesh, rgb_seq, depth_seq, intrinsics, poses_seq, opts: SLAMOptions, capacity: int):
    """Runs :func:`slam_sequence` with the batch sharded over the mesh's
    'data' axis and the map arena partitioned over its 'map' axis.

    Every rank calls it with the same global (B, L, ...) inputs and runs its
    data group's batch slice: :func:`slam_sequence` on the slice, on every
    :class:`SLAMOptions` path. With ``map > 1`` map rank ``m`` holds the
    global slots ``[m*CAP/map, (m+1)*CAP/map)``, and the result is bit-equal
    to one process's run of the slice.

    Returns:
        (map_state, poses): this rank's shards, ``map_state.data``
        (B/data, CAP/map, 12) with the global ``num_points`` (B/data,) and
        poses (B/data, L, 4, 4).
        :func:`~gradslam_tpu_torch.parallel.mesh.unshard_map_state` and
        :func:`~gradslam_tpu_torch.parallel.mesh.unshard_batch` assemble them.
    """
    shard = mesh.map_shard(capacity) if mesh.shape["map"] > 1 else None
    rgb, depth, K, poses = shard_batch(mesh, (rgb_seq, depth_seq, intrinsics, poses_seq))
    return slam_sequence(rgb, depth, K, poses, opts, capacity, shard=shard)


def sharded_train_step(mesh: Mesh, opts: SLAMOptions, capacity: int, lr: float = 1e-2):
    """An SGD step over :class:`DepthCalibParams` with the batch sharded
    over the mesh's 'data' axis and the arena over its 'map' axis.

    The returned ``step(params, rgb, depth, K, gt_poses) -> (new_params,
    loss)`` takes the global batch on every rank; each data group runs its
    slice's :func:`slam_loss` scaled by ``B_local / B``, the gradients are
    summed over the mesh (one ``all_reduce``) and one SGD step follows. Every
    rank returns the same new parameters and the global loss (the mean over
    the whole batch).

    Under ``map > 1`` every rank of a map group computes the same loss, and
    the owner-placed sums' backward hands each rank the gradient of the sum
    of the group's ``map`` copies with respect to its own inputs: the part
    through its shard and its own copy of the replicated part. Summed over
    the group that is ``map`` times the loss's gradient, so each rank
    differentiates its loss divided by ``map``.
    """
    m = mesh.shape["map"]

    def step(params: DepthCalibParams, rgb, depth, K, gt_poses):
        B = rgb.shape[0]
        rgb_l, depth_l, K_l, gt_l = shard_batch(mesh, (rgb, depth, K, gt_poses))
        shard = mesh.map_shard(capacity) if m > 1 else None
        loss = slam_loss(params, rgb_l, depth_l, K_l, gt_l, opts, capacity, shard=shard) * (rgb_l.shape[0] / B)
        grads = torch.autograd.grad(loss / m, [params.scale, params.bias])
        g = mesh.all_reduce(torch.stack(grads))
        total = mesh.all_reduce(loss.detach().clone(), "data")
        new = DepthCalibParams(device=params.scale.device)
        with torch.no_grad():
            new.scale.copy_(params.scale - lr * g[0])
            new.bias.copy_(params.bias - lr * g[1])
        return new, total

    return step
