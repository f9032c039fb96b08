"""Differentiable point-to-plane ICP (PyTorch port of
gradslam_tpu.odometry.icputils: the KNN and the projective association).

Everything is batched over B. The iteration loop is a Python loop with no
host sync: classic LM's accept/reject is a ``where`` gate and gradLM is
smooth by design. Row filtering is a weight mask, so filtered rows add
zero to the normal equations. Data association is :func:`ops.knn.knn`,
the Hopper kernel on the card, or the projective lookup of a per-pixel
model image (O(S) per iteration, no kernel of its own).

Every small product here is a broadcast multiply-and-sum, so it runs in
full float32 whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..geometry import se3_exp, transform_pointcloud
from ..geometry.projutils import matmul_small, project_points_to_pixels
from ..ops.knn import KnnTargets, knn, prepare_targets

__all__ = [
    "FramePoints",
    "solve_linear_system",
    "gauss_newton_solve",
    "gauss_newton_solve_projective",
    "huber_weights",
    "point_to_plane_ICP",
    "point_to_plane_gradICP",
    "point_to_plane_ICP_projective",
    "point_to_plane_gradICP_projective",
    "frame_points_from_maps",
    "downsample_rgbdimages",
    "downsample_pointclouds",
]


class FramePoints(NamedTuple):
    """A fixed-size masked point set."""

    points: torch.Tensor  # (B, N, 3)
    normals: torch.Tensor  # (B, N, 3)
    colors: torch.Tensor  # (B, N, 3)
    valid: torch.Tensor  # (B, N) bool


def _sum_each(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)`` over a trailing axis (``dim < 0``), each element of the
    leading (batch) axes summed on its own. The card's reduce kernel splits
    a reduction by the count of its outputs, so one batched sum gives an
    element other bits in a batch of 2 than alone; summed one at a time, a
    sequence's poses do not depend on the rest of its batch."""
    n = x.dim() + dim
    if n == 0:
        return x.sum(dim)
    parts = [e.sum(dim) for e in x.reshape((-1,) + x.shape[n:])]
    out = parts[0][None] if len(parts) == 1 else torch.stack(parts)
    return out.reshape(x.shape[:n] + out.shape[1:])


def solve_linear_system(
    A: torch.Tensor,
    b: torch.Tensor,
    damp: Union[float, torch.Tensor] = 1e-8,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Solves the damped normal equations ``(A^T W A + damp I) x = A^T W b``.

    Args:
        A: (..., N, D); b: (..., N, 1); damp: scalar or (...,);
        weights: optional (..., N) row weights (0 = filtered row).

    Returns:
        (..., D, 1). Differentiable w.r.t. A, b and damp. The batched solve
        does not check for singular systems, so it never waits on the host.
    """
    Aw = A if weights is None else A * weights[..., None]
    AtA = _sum_each(Aw[..., :, :, None] * A[..., :, None, :], -3)
    Atb = _sum_each(Aw[..., :, :, None] * b[..., :, None, :], -3)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    if torch.is_tensor(damp):
        damp = damp.to(A.dtype)[..., None, None]
    AtA = AtA + eye * damp
    return torch.linalg.solve_ex(AtA, Atb, check_errors=False)[0]


def huber_weights(residuals: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss: ``min(1, delta / |r|)``."""
    return torch.clamp(delta / torch.clamp(residuals.abs(), min=1e-12), max=1.0)


def gauss_newton_solve(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    dist_thresh: Optional[float] = None,
    src_valid: Optional[torch.Tensor] = None,
    tgt_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
    prepared_tgt: Optional[KnnTargets] = None,
    tgt_packed: Optional[torch.Tensor] = None,
):
    """One Gauss-Newton linearization of point-to-plane ICP.

    KNN-associates each source point with its closest target, then builds
    the rows ``A = [n, s x n]`` and ``b = n . (d - s)``.

    Args:
        src_pc: (B, S, 3); tgt_pc, tgt_normals: (B, T, 3).
        dist_thresh: optional squared-distance gate.
        src_valid / tgt_valid: optional (B, S) / (B, T) validity.
        robust_delta: optional Huber threshold on the residuals.
        prepared_tgt: optional :class:`KnnTargets` (hoisted target prep).
        tgt_packed: optional (B, T, 6) ``cat([tgt_pc, tgt_normals])`` rows,
            so the association is one wide gather.

    Returns:
        (A (B, S, 6), b (B, S, 1), weights (B, S), idx (B, S) int32).
    """
    dists, idx = knn(src_pc, prepared_tgt if prepared_tgt is not None else tgt_pc, tgt_valid)
    w = torch.isfinite(dists).to(src_pc.dtype)
    if dist_thresh is not None:
        w = w * (dists < dist_thresh)
    if src_valid is not None:
        w = w * src_valid
    if tgt_packed is None:
        tgt_packed = torch.cat([tgt_pc, tgt_normals], dim=-1)
    rows = torch.gather(tgt_packed, 1, idx.long()[..., None].expand(-1, -1, 6))
    A, b, w = _point_to_plane_rows(src_pc, rows[..., 0:3], rows[..., 3:6], w, robust_delta)
    return A, b, w, idx


def gauss_newton_solve_projective(
    src_pc: torch.Tensor,
    tgt_img: torch.Tensor,
    view_pose: torch.Tensor,
    intrinsics: torch.Tensor,
    H: int,
    W: int,
    dist_thresh: Optional[float] = None,
    src_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
):
    """One Gauss-Newton linearization with projective data association.

    Each source point is associated with the model row stored at its pixel
    in the ``view_pose`` camera (the projective ICP of KinectFusion and
    point-based fusion): one projection and one row gather per point.

    Args:
        src_pc: (B, S, 3) world-frame source points.
        tgt_img: (B, H*W, 7) per-pixel model rows ``[x, y, z, nx, ny, nz,
            valid]`` in the world frame.
        view_pose: (B, 4, 4) pose the model image was made at.
        intrinsics: (B, 4, 4) or (B, 1, 4, 4).
        dist_thresh / src_valid / robust_delta: as in
            :func:`gauss_newton_solve`.

    Returns:
        (A (B, S, 6), b (B, S, 1), weights (B, S), pix (B, S) int32): the
        weight is the in-frame mask times the row's valid channel times the
        gates. The association does not take part in the gradient.
    """
    B_, S = src_pc.shape[0], src_pc.shape[1]
    live = torch.ones((B_, S), dtype=torch.bool, device=src_pc.device)
    h, w_, inb = project_points_to_pixels(src_pc.detach(), live, view_pose, intrinsics, H, W)
    pix = h * W + w_
    rows = torch.gather(tgt_img, 1, pix.long()[..., None].expand(-1, -1, tgt_img.shape[-1]))
    assoc_pts, assoc_n = rows[..., 0:3], rows[..., 3:6]
    w = inb.to(src_pc.dtype) * rows[..., 6]
    if dist_thresh is not None:
        w = w * (((assoc_pts - src_pc) ** 2).sum(-1) < dist_thresh)
    if src_valid is not None:
        w = w * src_valid
    A, b, w = _point_to_plane_rows(src_pc, assoc_pts, assoc_n, w, robust_delta)
    return A, b, w, pix


def _point_to_plane_rows(src_pc, assoc_pts, assoc_n, w, robust_delta=None):
    """Point-to-plane rows ``A = [nx, ny, nz, nz*sy - ny*sz, nx*sz - nz*sx,
    ny*sx - nx*sy]`` and ``b = n . (d - s)``, with optional Huber weights."""
    nx, ny, nz = assoc_n.unbind(-1)
    sx, sy, sz = src_pc.unbind(-1)
    A = torch.stack(
        [nx, ny, nz, nz * sy - ny * sz, nx * sz - nz * sx, ny * sx - nx * sy], dim=-1
    )
    b = (assoc_n * (assoc_pts - src_pc)).sum(-1, keepdim=True)
    if robust_delta is not None:
        w = w * huber_weights(b[..., 0], robust_delta)
    return A, b, w


def _icp_common_step(solve_fn, src_pc, damp):
    """Linearize, solve, and measure the error before and after the step."""
    A, b, w, _ = solve_fn(src_pc)
    xi = solve_linear_system(A, b, damp, weights=w)[..., 0]  # (B, 6)
    residual_transform = se3_exp(xi)
    err = _sum_each(w * b[..., 0] ** 2, -1)
    one_step_pc = transform_pointcloud(src_pc, residual_transform)
    _, b1, w1, _ = solve_fn(one_step_pc)
    new_err = _sum_each(w1 * b1[..., 0] ** 2, -1)
    return xi, residual_transform, one_step_pc, err, new_err


def _identity(B, like):
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(B, 4, 4)


def _icp_loop(solve_fn, src_pc, initial_transform, numiters, damp):
    """Classic LM: a step is accepted (damping halves) when the lookahead
    error improves, else rejected (damping doubles).

    One association per iteration: the lookahead linearization is the next
    iteration's linearization when the step is accepted, and the current
    one is kept when it is rejected.
    """
    B = src_pc.shape[0]
    transform = _identity(B, src_pc) if initial_transform is None else initial_transform
    src = transform_pointcloud(src_pc, transform)
    A, b, w, _ = solve_fn(src)
    damp_v = torch.full((B,), damp, dtype=src_pc.dtype, device=src_pc.device)
    for _ in range(numiters):
        xi = solve_linear_system(A, b, damp_v, weights=w)[..., 0]
        rt = se3_exp(xi)
        err = _sum_each(w * b[..., 0] ** 2, -1)
        one_step = transform_pointcloud(src, rt)
        A1, b1, w1, _ = solve_fn(one_step)
        new_err = _sum_each(w1 * b1[..., 0] ** 2, -1)
        accept = new_err < err  # (B,)
        acc3 = accept[:, None, None]
        src = torch.where(acc3, one_step, src)
        A = torch.where(acc3, A1, A)
        b = torch.where(acc3, b1, b)
        w = torch.where(accept[:, None], w1, w)
        damp_v = torch.where(accept, damp_v / 2.0, damp_v * 2.0)
        transform = torch.where(acc3, matmul_small(rt, transform), transform)
    return transform


def _gradicp_loop(solve_fn, src_pc, initial_transform, numiters, damp, lambda_max, B, B2, nu):
    """GradLM: smooth damping and step gates (the gradSLAM paper):
    ``errdiff = clamp(new_err - err, -70, 70)``,
    ``damp *= lambda_min + (lambda_max - lambda_min) / (1 + exp(-B errdiff))``,
    and the step ``se3_exp(sigmoid * xi)`` with
    ``sigmoid = (1 + exp(-B2 errdiff)) ** (-1/nu)`` is always applied."""
    nbatch = src_pc.shape[0]
    lambda_min = 1.0 / lambda_max
    transform = _identity(nbatch, src_pc) if initial_transform is None else initial_transform
    src = transform_pointcloud(src_pc, transform)
    damp_v = torch.full((nbatch,), damp, dtype=src_pc.dtype, device=src_pc.device)
    for _ in range(numiters):
        xi, _, _, err, new_err = _icp_common_step(solve_fn, src, damp_v)
        errdiff = torch.clamp(new_err - err, -70.0, 70.0)
        damp_v = damp_v * (lambda_min + (lambda_max - lambda_min) / (1.0 + torch.exp(-B * errdiff)))
        sigmoid = 1.0 / (1.0 + torch.exp(-B2 * errdiff)) ** (1.0 / nu)
        rt = se3_exp(sigmoid[:, None] * xi)
        src = transform_pointcloud(src, rt)
        transform = matmul_small(rt, transform)
    return transform


def _knn_solver(tgt_pc, tgt_normals, dist_thresh, src_valid, tgt_valid, robust_delta):
    prepared = prepare_targets(tgt_pc, tgt_valid)  # loop-invariant
    packed = torch.cat([tgt_pc, tgt_normals], dim=-1)
    return lambda src: gauss_newton_solve(
        src, tgt_pc, tgt_normals, dist_thresh, src_valid, tgt_valid,
        robust_delta, prepared, packed,
    )


def point_to_plane_ICP(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    src_valid: Optional[torch.Tensor] = None,
    tgt_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
) -> torch.Tensor:
    """Classic point-to-plane ICP with an LM trust region.

    Args:
        src_pc: (B, S, 3); tgt_pc / tgt_normals: (B, T, 3).
        initial_transform: optional (B, 4, 4).

    Returns:
        (B, 4, 4) transforms aligning src to tgt.
    """
    solve_fn = _knn_solver(tgt_pc, tgt_normals, dist_thresh, src_valid, tgt_valid, robust_delta)
    return _icp_loop(solve_fn, src_pc, initial_transform, numiters, damp)


def point_to_plane_gradICP(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    lambda_max: float = 2.0,
    B: float = 1.0,
    B2: float = 1.0,
    nu: float = 200.0,
    src_valid: Optional[torch.Tensor] = None,
    tgt_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
) -> torch.Tensor:
    """GradLM point-to-plane ICP, the gradSLAM paper's smooth LM.

    Two KNN associations per iteration (the step and its lookahead).

    Returns:
        (B, 4, 4) transforms aligning src to tgt.
    """
    solve_fn = _knn_solver(tgt_pc, tgt_normals, dist_thresh, src_valid, tgt_valid, robust_delta)
    return _gradicp_loop(
        solve_fn, src_pc, initial_transform, numiters, damp, lambda_max, B, B2, nu
    )


def _projective_solver(tgt_img, view_pose, intrinsics, H, W, dist_thresh, src_valid, robust_delta):
    return lambda src: gauss_newton_solve_projective(
        src, tgt_img, view_pose, intrinsics, H, W, dist_thresh, src_valid, robust_delta
    )


def point_to_plane_ICP_projective(
    src_pc: torch.Tensor,
    tgt_img: torch.Tensor,
    view_pose: torch.Tensor,
    intrinsics: torch.Tensor,
    H: int,
    W: int,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    src_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
) -> torch.Tensor:
    """Classic point-to-plane ICP with projective association against the
    (B, H*W, 7) model image ``tgt_img`` made at ``view_pose`` (see
    :func:`gauss_newton_solve_projective`)."""
    solve_fn = _projective_solver(tgt_img, view_pose, intrinsics, H, W, dist_thresh, src_valid, robust_delta)
    return _icp_loop(solve_fn, src_pc, initial_transform, numiters, damp)


def point_to_plane_gradICP_projective(
    src_pc: torch.Tensor,
    tgt_img: torch.Tensor,
    view_pose: torch.Tensor,
    intrinsics: torch.Tensor,
    H: int,
    W: int,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    lambda_max: float = 2.0,
    B: float = 1.0,
    B2: float = 1.0,
    nu: float = 200.0,
    src_valid: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
) -> torch.Tensor:
    """GradLM point-to-plane ICP with projective association (see
    :func:`point_to_plane_ICP_projective`)."""
    solve_fn = _projective_solver(tgt_img, view_pose, intrinsics, H, W, dist_thresh, src_valid, robust_delta)
    return _gradicp_loop(
        solve_fn, src_pc, initial_transform, numiters, damp, lambda_max, B, B2, nu
    )


def frame_points_from_maps(
    global_vertex_map: torch.Tensor,
    global_normal_map: torch.Tensor,
    rgb_image: torch.Tensor,
    valid_mask: torch.Tensor,
    ds_ratio: int,
) -> FramePoints:
    """Strided ``[::ds, ::ds]`` subsampling of (B, 1, H, W, C) frame maps
    into a fixed-size masked point set."""
    B = global_vertex_map.shape[0]
    sl = (slice(None), 0, slice(None, None, ds_ratio), slice(None, None, ds_ratio))
    return FramePoints(
        points=global_vertex_map[sl].reshape(B, -1, 3),
        normals=global_normal_map[sl].reshape(B, -1, 3),
        colors=rgb_image[sl].reshape(B, -1, 3),
        valid=valid_mask[sl].reshape(B, -1),
    )


def downsample_rgbdimages(rgbdimages, ds_ratio: int):
    """A sequence-length-1 :class:`RGBDImages` batch, strided by
    ``ds_ratio`` in both axes, as :class:`Pointclouds` of its valid-depth
    pixels (global coordinates, in pixel order)."""
    from ..structures.utils import valid_points_first

    if rgbdimages.shape[1] != 1:
        raise ValueError(f"expected sequence length 1, got {rgbdimages.shape[1]}")
    rgbd = rgbdimages.to_channels_last()
    fp = frame_points_from_maps(rgbd.global_vertex_map, rgbd.global_normal_map, rgbd.rgb_image,
                                rgbd.valid_depth_mask, ds_ratio)
    return valid_points_first(fp.points, fp.normals, fp.colors, fp.valid)


def downsample_pointclouds(pointclouds, pc2im_bnhw, ds_ratio: int):
    """The map points of an active table (``find_active_map_points``) whose
    pixel lies on the ``ds_ratio`` grid, as new :class:`Pointclouds`."""
    from ..structures import Pointclouds

    tab = pc2im_bnhw.long()
    tab = tab[(tab[:, 2] % ds_ratio == 0) & (tab[:, 3] % ds_ratio == 0)]
    rows = [tab[tab[:, 0] == b][:, 1] for b in range(len(pointclouds))]
    pick = lambda padded: None if padded is None else [padded[b][r] for b, r in enumerate(rows)]
    return Pointclouds(
        points=pick(pointclouds.points_padded),
        normals=pick(pointclouds.normals_padded),
        colors=pick(pointclouds.colors_padded),
    )
