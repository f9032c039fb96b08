"""Sequence-parallel SLAM: the trajectory cut into overlapping chunks that
run in parallel (PyTorch port of gradslam_tpu.parallel.seqpar).

The L-frame sequence is cut into ``n_chunks`` chunks that overlap by one
frame; each chunk runs local SLAM from identity, the chunk axis folded into
the batch axis (sharded over a mesh's 'data' axis when one is given), and
the chunk-local trajectories are stitched exactly at the shared frames:

    chunk 0: frames [0 .. Lc-1]
    chunk 1: frames [Lc-1 .. 2Lc-2]      <- first frame = chunk 0's last
    ...

Chunk c+1's first frame is chunk c's last, so its global origin is
``origin_c @ local_poses_c[-1]``: stitching is composition, no alignment
solve. An optional pose-graph pass (:func:`pose_graph_refine`, all batch
elements in one batched solve) polishes the stitched trajectory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.projutils import matmul_small
from ..slam.icpslam import SLAMOptions, slam_sequence
from ..structures.maparena import MapState
from .pose_refine import PoseGraph, pose_graph_refine

__all__ = ["SeqParResult", "chunk_sequence", "sequence_parallel_slam", "merge_chunk_maps"]


class SeqParResult(NamedTuple):
    """Result of a sequence-parallel run.

    Attributes:
        poses: (B, L, 4, 4) stitched global trajectory.
        chunk_maps: :class:`MapState` with leading axis B*n_chunks
            (chunk-local frames); :func:`merge_chunk_maps` makes global
            point clouds of it. With a mesh it is assembled on every rank.
        chunk_origins: (B, n_chunks, 4, 4) global chunk origin poses.
        n_chunks: the chunk count.
        chunk_len: frames per chunk (with the one-frame overlap).
    """

    poses: torch.Tensor
    chunk_maps: MapState
    chunk_origins: torch.Tensor
    n_chunks: int
    chunk_len: int


def chunk_sequence(x: torch.Tensor, n_chunks: int, chunk_len: int) -> torch.Tensor:
    """Splits (B, L, ...) into (B*n_chunks, chunk_len, ...) overlapping
    chunks (stride chunk_len-1); the tail chunk is padded by repeating the
    last frame."""
    B, L = x.shape[:2]
    stride = chunk_len - 1
    need = stride * (n_chunks - 1) + chunk_len
    if need > L:
        x = torch.cat([x] + [x[:, -1:]] * (need - L), dim=1)
    chunks = torch.stack([x[:, c * stride : c * stride + chunk_len] for c in range(n_chunks)], dim=1)
    return chunks.reshape((B * n_chunks, chunk_len) + tuple(x.shape[2:]))


def _unchunk_poses(local_poses, B, n_chunks, chunk_len, L):
    """Stitches (B*n, Lc, 4, 4) local poses into (B, L, 4, 4) global ones;
    returns them with the (B, n, 4, 4) chunk origins."""
    lp = local_poses.reshape(B, n_chunks, chunk_len, 4, 4)
    origin = torch.eye(4, dtype=lp.dtype, device=lp.device).expand(B, 4, 4)
    origins = []
    for c in range(n_chunks):
        origins.append(origin)
        origin = matmul_small(origin, lp[:, c, -1])
    origins = torch.stack(origins, dim=1)  # (B, n, 4, 4)
    global_poses = matmul_small(origins[:, :, None], lp)
    # drop the overlapping first frame of chunks 1.. and flatten
    rest = global_poses[:, 1:, 1:].reshape(B, -1, 4, 4)
    return torch.cat([global_poses[:, 0], rest], dim=1)[:, :L], origins


def sequence_parallel_slam(
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    opts: SLAMOptions,
    n_chunks: int,
    chunk_capacity: Optional[int] = None,
    mesh=None,
    refine: bool = False,
    refine_iters: int = 5,
) -> SeqParResult:
    """Runs SLAM with the sequence partitioned into parallel chunks.

    Args:
        rgb_seq / depth_seq: (B, L, H, W, 3/1).
        intrinsics: (B, 1, 4, 4).
        opts: SLAM options; the odometry must be 'icp' or 'gradicp' (a
            chunk has no ground truth).
        n_chunks: the number of chunks; the chunk axis folds into the batch
            axis, so with a mesh B*n_chunks must be a multiple of its 'data'
            axis.
        chunk_capacity: arena rows per chunk (default chunk_len*H*W).
        mesh: optional :class:`~gradslam_tpu_torch.parallel.mesh.Mesh`;
            every rank passes the same inputs and runs its data group's
            chunks, and the poses and chunk maps are assembled on every
            rank (owner-placed sums over 'data').
        refine: run pose-graph Gauss-Newton over the stitched trajectory
            with consecutive-frame odometry edges.

    Returns:
        :class:`SeqParResult`.
    """
    if opts.odom == "gt":
        raise ValueError("sequence-parallel SLAM requires ICP odometry")
    B, L, H, W, _ = rgb_seq.shape
    chunk_len = -(-(L - 1) // max(1, n_chunks)) + 1  # ceil((L-1)/n) + 1
    capacity = chunk_capacity or chunk_len * H * W

    chunks = (chunk_sequence(rgb_seq, n_chunks, chunk_len), chunk_sequence(depth_seq, n_chunks, chunk_len),
              torch.repeat_interleave(intrinsics, n_chunks, dim=0))
    if mesh is None:
        chunk_maps, local_poses = slam_sequence(*chunks, None, opts, capacity)
    else:
        from .mesh import shard_batch, unshard_batch

        maps, poses = slam_sequence(*shard_batch(mesh, chunks), None, opts, capacity)
        chunk_maps, local_poses = unshard_batch(mesh, (maps, poses))

    poses, origins = _unchunk_poses(local_poses, B, n_chunks, chunk_len, L)
    if refine:
        poses = _refine_trajectory(poses, refine_iters)
    return SeqParResult(poses=poses, chunk_maps=chunk_maps, chunk_origins=origins, n_chunks=n_chunks,
                        chunk_len=chunk_len)


def _refine_trajectory(poses: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Pose-graph polish with consecutive-frame odometry edges, every batch
    element in one batched solve."""
    from ..geometry import relative_transformation

    B, L = poses.shape[:2]
    i = torch.arange(L - 1, dtype=torch.int32, device=poses.device)
    edges = torch.stack([i, i + 1], dim=-1).expand(B, L - 1, 2)
    Z = relative_transformation(poses[:, :-1], poses[:, 1:], orthogonal_rotations=True)
    graph = PoseGraph(poses=poses, edges=edges, measurements=Z, weights=poses.new_ones((B, L - 1)))
    return pose_graph_refine(graph, num_iters=num_iters)


def merge_chunk_maps(result: SeqParResult, batch_size: int, dedup_voxel: Optional[float] = None):
    """Merges the chunk-local maps into one global point cloud per batch
    element.

    Each chunk's live rows move by its global origin and the chunks are
    joined (a host boundary: the counts are read). The overlap frames leave
    duplicate points at the chunk seams; ``dedup_voxel`` (a cell size in
    map units, e.g. the fusion's ``dist_th``) runs a voxel fusion pass
    (:func:`~gradslam_tpu_torch.ops.voxel.voxel_merge`) that collapses them
    into single confidence-weighted points.

    Returns:
        :class:`~gradslam_tpu_torch.structures.Pointclouds`.
    """
    from ..structures import Pointclouds

    maps, n = result.chunk_maps, result.n_chunks
    data, origins = maps.data, result.chunk_origins
    counts = maps.num_points.tolist()
    parts = []
    for b in range(batch_size):
        pts, nrms, cols, feats = [], [], [], []
        for c in range(n):
            k = counts[b * n + c]
            if k == 0:
                continue
            rows, T = data[b * n + c, :k], origins[b, c]
            R = T[:3, :3]
            pts.append((rows[:, None, 0:3] * R[None]).sum(-1) + T[:3, 3])
            nrms.append((rows[:, None, 3:6] * R[None]).sum(-1))
            cols.append(rows[:, 6:9])
            feats.append(rows[:, 9:10])
        cat = lambda xs, w: torch.cat(xs) if xs else data.new_zeros((0, w))
        parts.append([cat(pts, 3), cat(nrms, 3), cat(cols, 3), cat(feats, 1)])

    if dedup_voxel is not None:
        from ..ops.voxel import voxel_merge

        for part in parts:
            m = part[0].shape[0]
            if m == 0:
                continue
            live = torch.ones((1, m), dtype=torch.bool, device=data.device)
            *merged, mlive = voxel_merge(*(x[None] for x in part), live, dedup_voxel)
            k = int(mlive[0].sum())
            part[:] = [x[0, :k] for x in merged]

    return Pointclouds(points=[p[0] for p in parts], normals=[p[1] for p in parts], colors=[p[2] for p in parts],
                       features=[p[3] for p in parts])
