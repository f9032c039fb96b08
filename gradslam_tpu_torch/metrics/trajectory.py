"""Trajectory evaluation metrics, ATE-RMSE and RPE (PyTorch port of
gradslam_tpu.metrics.trajectory).

Conventions follow the TUM RGB-D benchmark tooling: ATE aligns the
estimated trajectory to ground truth with a rigid (or similarity) Umeyama
alignment and reports the RMSE of the translational residuals; RPE compares
relative motions over a fixed frame delta. Every function is differentiable
and takes a leading batch dimension.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import inverse_transformation, relative_transformation

__all__ = ["umeyama_alignment", "ate_rmse", "rpe", "trajectory_positions"]


def trajectory_positions(poses: torch.Tensor) -> torch.Tensor:
    """The (..., L, 3) translations of (..., L, 4, 4) poses."""
    return poses[..., :3, 3]


def umeyama_alignment(
    src: torch.Tensor, dst: torch.Tensor, with_scale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares rigid (optionally similarity) alignment ``dst ~ s R src + t``.

    Umeyama (1991): closed-form SVD solution, with the reflection fix (the
    last singular direction flipped when ``det(U) det(V^T) < 0``). The SVD's
    backward is undefined where singular values repeat (a degenerate point
    set, such as fewer than four points).

    Args:
        src, dst: (..., N, 3) corresponding points.

    Returns:
        (R (..., 3, 3), t (..., 3), s (...)).
    """
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd.transpose(-1, -2) @ xs) / src.shape[-2]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    one = torch.ones_like(det)
    sdiag = torch.stack([one, one, torch.where(det < 0, -one, one)], dim=-1)
    R = (U * sdiag[..., None, :]) @ Vt
    if with_scale:
        var_s = (xs * xs).sum(-1).mean(-1)
        s = (D * sdiag).sum(-1) / var_s
    else:
        s = one
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return R, t, s


def ate_rmse(
    pred_poses: torch.Tensor,
    gt_poses: torch.Tensor,
    align: bool = True,
    with_scale: bool = False,
) -> torch.Tensor:
    """Absolute trajectory error (RMSE of aligned positions).

    Args:
        pred_poses / gt_poses: (L, 4, 4) or (B, L, 4, 4) pose trajectories.
        align: apply the Umeyama rigid alignment first (standard ATE).
        with_scale: a similarity alignment instead.

    Returns:
        scalar (or (B,)) ATE-RMSE in trajectory units (meters).
    """
    p = trajectory_positions(pred_poses)
    g = trajectory_positions(gt_poses)
    if align:
        R, t, s = umeyama_alignment(p, g, with_scale)
        p = s[..., None, None] * (p @ R.transpose(-1, -2)) + t[..., None, :]
    return torch.sqrt(((p - g) ** 2).sum(-1).mean(-1))


def rpe(
    pred_poses: torch.Tensor, gt_poses: torch.Tensor, delta: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative pose error over a frame delta.

    Args:
        pred_poses / gt_poses: (L, 4, 4) or (B, L, 4, 4) trajectories.
        delta: frame offset.

    Returns:
        (trans_rmse, rot_rmse_rad), scalars (or (B,)): RMSE of the
        translational error (meters) and of the rotational error (radians)
        of the relative-motion residuals.
    """
    p1, p2 = pred_poses[..., :-delta, :, :], pred_poses[..., delta:, :, :]
    g1, g2 = gt_poses[..., :-delta, :, :], gt_poses[..., delta:, :, :]
    rel_p = relative_transformation(p1, p2, orthogonal_rotations=True)
    rel_g = relative_transformation(g1, g2, orthogonal_rotations=True)
    err = inverse_transformation(rel_g) @ rel_p
    terr = torch.linalg.norm(err[..., :3, 3], dim=-1)
    trace = err[..., 0, 0] + err[..., 1, 1] + err[..., 2, 2]
    ang = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    return torch.sqrt((terr**2).mean(-1)), torch.sqrt((ang**2).mean(-1))
