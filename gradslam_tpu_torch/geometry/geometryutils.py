"""General 3D geometry utilities (PyTorch port of gradslam_tpu.geometry.geometryutils)."""

from __future__ import annotations

import numpy as np
import torch

from .projutils import homogenize_points, matmul_small, matvec, unhomogenize_points

__all__ = [
    "create_meshgrid",
    "normalize_quaternion",
    "quaternion_to_axisangle",
    "quaternion_to_rotation_matrix",
    "inverse_transformation",
    "compose_transformations",
    "relative_transformation",
    "transform_pointcloud",
    "transform_normals",
    "cam2pixel",
    "pixel2cam",
]


def create_meshgrid(
    height: int,
    width: int,
    normalized_coords: bool = True,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """(1, H, W, 2) coordinate grid: ``[..., 0]`` indexes rows, ``[..., 1]``
    columns; both span [-1, 1] when ``normalized_coords``, else they are the
    integer pixel indices."""
    if normalized_coords:
        # numpy's linspace, as the JAX package spaces it
        xs = torch.as_tensor(np.linspace(-1.0, 1.0, height, dtype=np.float32), device=device)
        ys = torch.as_tensor(np.linspace(-1.0, 1.0, width, dtype=np.float32), device=device)
    else:
        # made on the device: no host copy inside the frame loop
        xs = torch.arange(height, dtype=torch.float32, device=device)
        ys = torch.arange(width, dtype=torch.float32, device=device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="ij"), dim=-1)
    return grid[None].to(dtype)


def normalize_quaternion(quaternion: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalizes quaternions along the last dim."""
    if quaternion.shape[-1] != 4:
        raise ValueError(f"quaternion must be (..., 4), got {tuple(quaternion.shape)}")
    norm = torch.linalg.vector_norm(quaternion, dim=-1, keepdim=True)
    return quaternion / torch.clamp(norm, min=eps)


def quaternion_to_axisangle(quaternion: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Converts (x, y, z, w) quaternions to axis-angle vectors."""
    if quaternion.shape[-1] != 4:
        raise ValueError(f"quaternion must be (..., 4), got {tuple(quaternion.shape)}")
    q1, q2, q3, w = quaternion.unbind(-1)
    sin_sq_theta = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(torch.clamp(sin_sq_theta, min=0.0))
    cos_theta = w
    # two_theta = 2 * atan2(sin, cos) choosing the short arc
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k_pos = two_theta / torch.clamp(sin_theta, min=eps)
    k_neg = torch.full_like(sin_theta, 2.0)
    k = torch.where(sin_sq_theta > 0.0, k_pos, k_neg)
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def quaternion_to_rotation_matrix(quaternion: torch.Tensor) -> torch.Tensor:
    """Converts (x, y, z, w) quaternions to (..., 3, 3) rotation matrices
    (normalizing first)."""
    if quaternion.shape[-1] != 4:
        raise ValueError(f"quaternion must be (..., 4), got {tuple(quaternion.shape)}")
    q = normalize_quaternion(quaternion)
    x, y, z, w = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    one = torch.ones_like(x)
    mat = torch.stack(
        [
            one - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, one - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, one - (txx + tyy),
        ],
        dim=-1,
    )
    return mat.reshape(q.shape[:-1] + (3, 3))


def inverse_transformation(trans: torch.Tensor) -> torch.Tensor:
    """Inverts rigid transforms: ``[R t; 0 1]^-1 = [R^T, -R^T t; 0 1]``."""
    if tuple(trans.shape[-2:]) != (4, 4):
        raise ValueError(f"trans must be (..., 4, 4), got {tuple(trans.shape)}")
    from .se3 import rt_matrix

    rmatT = trans[..., :3, :3].transpose(-1, -2)
    t_inv = -matvec(rmatT, trans[..., :3, 3])
    return rt_matrix(rmatT, t_inv)


def compose_transformations(trans_ab: torch.Tensor, trans_bc: torch.Tensor) -> torch.Tensor:
    """Composes homogeneous transforms: ``trans_ab @ trans_bc``."""
    return matmul_small(trans_ab, trans_bc)


def relative_transformation(
    trans_01: torch.Tensor, trans_02: torch.Tensor, orthogonal_rotations: bool = False
) -> torch.Tensor:
    """Relative transform ``T_12 = T_01^-1 @ T_02`` (analytic rigid inverse
    when ``orthogonal_rotations``, else a general matrix inverse)."""
    if orthogonal_rotations:
        inv = inverse_transformation(trans_01)
    else:
        inv = torch.linalg.inv(trans_01)
    return matmul_small(inv, trans_02)


def transform_pointcloud(pointcloud: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Applies (..., 4, 4) rigid transforms to (..., N, 3) pointclouds.

    The four homogeneous terms are summed pairwise,
    ``(R0 x + R1 y) + (R2 z + t)``, as the JAX package's CPU product does,
    so projected pixels agree bit for bit.
    """
    if pointcloud.shape[-1] != 3:
        raise ValueError(f"pointcloud must be (..., N, 3), got {tuple(pointcloud.shape)}")
    homo = homogenize_points(pointcloud)  # (..., N, 4)
    T = transform[..., None, :, :]  # (..., 1, 4, 4)
    p = [T[..., j] * homo[..., j : j + 1] for j in range(4)]  # (..., N, 4)
    tformed = (p[0] + p[1]) + (p[2] + p[3])
    return unhomogenize_points(tformed)


def transform_normals(normals: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Rotates (..., N, 3) normals by the rotation block of (..., 4, 4) transforms."""
    if normals.shape[-1] != 3:
        raise ValueError(f"normals must be (..., N, 3), got {tuple(normals.shape)}")
    return matvec(transform[..., None, :3, :3], normals)


def cam2pixel(cam_coords_src: torch.Tensor, dst_proj_src: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Transforms camera-frame coordinates to pixel coordinates.

    Legacy helper (reference geometryutils.py:611): applies a (4, 4)
    projection to (..., H, W, 3) camera coordinates and perspective-divides;
    a depth within ``eps`` of 0 divides by 1.
    """
    if cam_coords_src.shape[-1] != 3:
        raise ValueError(f"cam_coords_src must be (..., 3), got {tuple(cam_coords_src.shape)}")
    projected = matvec(dst_proj_src, homogenize_points(cam_coords_src))
    z = projected[..., 2:3]
    z_safe = torch.where(z.abs() > eps, z, torch.ones_like(z))
    return projected[..., :2] / z_safe


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor, pixel_coords: torch.Tensor) -> torch.Tensor:
    """Transforms pixel coordinates and depth into camera-frame points.

    Legacy helper (reference geometryutils.py:671): ``depth * Kinv @ p`` for
    homogeneous (..., H, W, 3) pixel coordinates; ``depth`` is (..., H, W)
    or (..., H, W, 1).
    """
    kinv = torch.as_tensor(intrinsics_inv)[..., :3, :3].reshape(3, 3)
    rays = matvec(kinv, pixel_coords)
    depth = torch.as_tensor(depth)
    if depth.dim() == rays.dim() - 1:
        depth = depth[..., None]
    return rays * depth
