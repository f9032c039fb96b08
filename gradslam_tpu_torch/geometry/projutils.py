"""Projective geometry utilities (PyTorch port of gradslam_tpu.geometry.projutils).

Every function is batched, keeps static shapes (no data-dependent control
flow) and is differentiable. Small matrix products are written out as
multiply-and-sum over the short axis, so they run in full float32 whatever
the global TF32 flags say.

Conventions:
  - Pixel coordinates are (u, v) = (column, row).
  - Intrinsics are 4x4 (or 3x3) matrices with fx = K[0,0], fy = K[1,1],
    cx = K[0,2], cy = K[1,2].
"""

from __future__ import annotations

import torch

__all__ = [
    "homogenize_points",
    "unhomogenize_points",
    "project_points",
    "unproject_points",
    "inverse_intrinsics",
    "project_points_to_pixels",
]


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(..., I, J) @ (..., J) -> (..., I)`` as a multiply-and-sum over J."""
    return (M * v[..., None, :]).sum(-1)


def matmul_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(..., I, K) @ (..., K, J)`` for small K, as a multiply-and-sum."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def homogenize_points(pts: torch.Tensor) -> torch.Tensor:
    """Appends a homogeneous coordinate (1.0): (..., K) -> (..., K+1)."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def unhomogenize_points(pts: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Divides by the homogeneous coordinate, guarding ``|w| <= eps``.

    Degenerate points pass through unscaled (``where(|w| > eps, 1/w, 1)``)
    rather than producing inf/nan.
    """
    if pts.shape[-1] < 2:
        raise ValueError(
            f"pts must have at least 2 coordinates in the last dim, got {tuple(pts.shape)}"
        )
    w = pts[..., -1:]
    scale = torch.where(w.abs() > eps, 1.0 / w, torch.ones_like(w))
    return pts[..., :-1] * scale


def project_points(
    cam_coords: torch.Tensor, proj_mat: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Projects camera-frame points (..., 3) or (..., 4) to (..., 2) pixels.

    ``proj_mat`` (..., 4, 4) broadcasts over the point batch dims, or over
    the points dim when given one matrix per batch element. The division is
    guarded by ``where(z != 0, z, 1)``.
    """
    if cam_coords.shape[-1] == 3:
        cam_coords = homogenize_points(cam_coords)
    elif cam_coords.shape[-1] != 4:
        raise ValueError(
            f"cam_coords last dim must be 3 or 4, got {tuple(cam_coords.shape)}"
        )
    try:
        torch.broadcast_shapes(proj_mat.shape[:-2], cam_coords.shape[:-1])
    except RuntimeError:
        proj_mat = proj_mat[..., None, :, :]
    projected = matvec(proj_mat, cam_coords)
    z = projected[..., 2:3]
    z_safe = torch.where(z != 0, z, torch.ones_like(z))
    return projected[..., :2] / z_safe


def unproject_points(
    pixel_coords: torch.Tensor, intrinsics_inv: torch.Tensor, depths: torch.Tensor
) -> torch.Tensor:
    """``depth * Kinv @ [u, v, 1]``: (..., 2|3) pixels -> (..., 3) points."""
    if pixel_coords.shape[-1] == 2:
        pixel_coords = homogenize_points(pixel_coords)
    elif pixel_coords.shape[-1] != 3:
        raise ValueError(
            f"pixel_coords last dim must be 2 or 3, got {tuple(pixel_coords.shape)}"
        )
    rays = matvec(intrinsics_inv[..., :3, :3], pixel_coords)
    return rays * depths[..., None]


def inverse_intrinsics(K: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Analytic inverse of a pinhole intrinsics matrix.

    Uses the ``1 / (f + eps)`` terms of the reference so derived vertex
    maps match the golden data.
    """
    if tuple(K.shape[-2:]) not in ((3, 3), (4, 4)):
        raise ValueError(f"K must be (..., 3, 3) or (..., 4, 4), got {tuple(K.shape)}")
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    Kinv = torch.zeros_like(K)
    Kinv[..., 0, 0] = 1.0 / (fx + eps)
    Kinv[..., 1, 1] = 1.0 / (fy + eps)
    Kinv[..., 0, 2] = -cx / (fx + eps)
    Kinv[..., 1, 2] = -cy / (fy + eps)
    Kinv[..., 2, 2] = 1.0
    Kinv[..., -1, -1] = 1.0
    return Kinv


def project_points_to_pixels(
    points: torch.Tensor,
    valid: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    H: int,
    W: int,
):
    """Projects world points into the camera at ``pose``: pixel rows/cols.

    Transform by ``pose^-1``, keep points with z > 0, pinhole-project,
    bounds-test with the reference's guards (``-1e-3 < u < W - 0.999``),
    then round half to even and clamp into the frame.

    Args:
        points: (B, N, 3) world-frame points.
        valid: (B, N) bool point validity.
        pose: (B, 4, 4) camera-to-world pose.
        intrinsics: (B, 4, 4) or (B, 1, 4, 4).

    Returns:
        (h, w, active): (B, N) int32 pixel rows/cols (clamped into the
        frame) and the (B, N) bool in-bounds mask.
    """
    from .geometryutils import inverse_transformation, transform_pointcloud

    tinv = inverse_transformation(pose)
    pts_cam = transform_pointcloud(points, tinv)
    z = pts_cam[..., 2]
    K = intrinsics[:, 0] if intrinsics.dim() == 4 else intrinsics
    fx = K[..., 0, 0][:, None]
    fy = K[..., 1, 1][:, None]
    cx = K[..., 0, 2][:, None]
    cy = K[..., 1, 2][:, None]
    z_safe = torch.where(z != 0, z, torch.ones_like(z))
    u = (pts_cam[..., 0] * fx + z * cx) / z_safe
    v = (pts_cam[..., 1] * fy + z * cy) / z_safe
    active = (
        (u > -1e-3)
        & (u < W - 0.999)
        & (v > -1e-3)
        & (v < H - 0.999)
        & (z > 0)
        & valid.bool()
    )
    h = torch.clamp(torch.round(v), 0, H - 1).to(torch.int32)
    w = torch.clamp(torch.round(u), 0, W - 1).to(torch.int32)
    return h, w, active
