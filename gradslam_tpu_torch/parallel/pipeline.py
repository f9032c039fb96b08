"""Pipeline parallelism: 2-stage pipelined SLAM over a pair of ranks
(PyTorch port of gradslam_tpu.parallel.pipeline).

  - stage 0 (ingest, rank 0 of the pair): the pose-independent frame maps
    of frame t+1 (vertex map, normal map, valid mask:
    ``icpslam._frame_maps_local``);
  - stage 1 (solve, rank 1): localization and fusion of frame t, on the
    maps that stage 0 handed over at the previous step.

The handoff is one ``broadcast`` in the pair's group of the maps packed as
(B, H, W, 7) floats a step; while rank 1 solves frame t, rank 0 ingests
frame t+1, so a step takes ``max(ingest, solve) + transfer``. The schedule
is exact: the same functions run on the same inputs, one step earlier on
another rank, so the result is :func:`slam_sequence`'s. Only the
pose-independent ingest pipelines: odometry of frame t+1 needs the map
fused at frame t, so a 3-stage split (ingest / odometry / fusion) would not
be exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..slam.icpslam import SLAMOptions, _frame_maps_local, slam_init_state, slam_step_state
from ..structures.maparena import MapState
from ..utils.device import resolve_device

__all__ = ["PipeMesh", "pipeline_mesh", "pipelined_slam_sequence"]


class PipeMesh:
    """A pair of ranks with the ``pipe`` axis: ``ranks[0]`` ingests,
    ``ranks[1]`` solves. ``index`` is this rank's place in the pair (None
    outside it)."""

    def __init__(self, ranks, group, device: torch.device):
        self.ranks = tuple(ranks)
        self.group = group
        self.device = device
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else None

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x


def pipeline_mesh(device=None) -> PipeMesh:
    """The pair of ranks 0 and 1 of an initialized process group. Every rank
    of the world calls it (it makes the pair's group).

    Args:
        device: the device this rank computes on; default ``"cuda"``.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < 2:
        raise ValueError("pipeline parallelism needs at least 2 ranks")
    group = dist.group.WORLD if n == 2 else dist.new_group([0, 1])
    return PipeMesh((0, 1), group, resolve_device(device))


def pipelined_slam_sequence(
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    opts: SLAMOptions,
    capacity: int,
    mesh: Optional[PipeMesh] = None,
) -> Tuple[MapState, torch.Tensor]:
    """Runs :func:`~gradslam_tpu_torch.slam.slam_sequence` with the
    frame-map ingest stage pipelined onto a second rank.

    Both ranks of the pair call it with the same inputs.

    Args:
        rgb_seq / depth_seq: (B, L, H, W, 3/1) sequences (L >= 2).
        mesh: the pair (default :func:`pipeline_mesh`).

    Returns:
        (map_state, poses (B, L, 4, 4)) on both ranks: equal to
        ``slam_sequence``'s (rank 1 broadcasts them at the end).

    Requires non-gt odometry (gt poses need no pipeline) and L >= 2.
    """
    if opts.odom == "gt":
        raise ValueError("pipelining gt odometry is pointless: use slam_sequence")
    B, L, H, W, _ = rgb_seq.shape
    if L < 2:
        raise ValueError("need at least 2 frames to pipeline")
    mesh = mesh or pipeline_mesh()
    if mesh.index is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the pipeline pair {mesh.ranks}")
    dev = mesh.device
    rgb, dep, K = (x.to(dev) for x in (rgb_seq, depth_seq, intrinsics))
    dtype = rgb.dtype
    handoff = torch.empty((B, H, W, 7), dtype=dtype, device=dev)

    def ingest(t):
        """Stage 0: frame t's maps, handed to stage 1."""
        if mesh.index == 0:
            vm, nm, valid = _frame_maps_local(dep[:, t], K)
            handoff.copy_(torch.cat([vm, nm, valid[..., None].to(dtype)], dim=-1))
        mesh.broadcast(handoff, 0)
        return handoff[..., 0:3].clone(), handoff[..., 3:6].clone(), handoff[..., 6] > 0.5

    if mesh.index == 1:
        state = slam_init_state(rgb[:, 0], dep[:, 0], K, opts, capacity)
        poses = [state.pose]
    maps = ingest(1)
    for t in range(1, L):
        if mesh.index == 1:
            state = slam_step_state(state, rgb[:, t], dep[:, t], K, opts, local_maps=maps)
            poses.append(state.pose)
        if t + 1 < L:
            maps = ingest(t + 1)

    if mesh.index == 1:
        data, num_points, poses = state.map_state.data, state.map_state.num_points, torch.stack(poses, dim=1)
    else:
        data = torch.empty((B, capacity, 12), dtype=dtype, device=dev)
        num_points = torch.empty((B,), dtype=torch.int32, device=dev)
        poses = torch.empty((B, L, 4, 4), dtype=dtype, device=dev)
    for x in (data, num_points, poses):
        mesh.broadcast(x, 1)
    return MapState(data, num_points), poses
