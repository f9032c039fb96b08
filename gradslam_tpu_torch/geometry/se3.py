"""Lie group ops for SO(3)/SE(3) (PyTorch port of gradslam_tpu.geometry.se3).

Batched over arbitrary leading dims. The small-angle branch
(``||omega|| < 1e-6``: rotation and V both ``I + hat(omega)``, as the
reference does) is a ``torch.where``, safe for autograd.
"""

from __future__ import annotations

import torch

from .projutils import matmul_small, matvec

_EPS = 1e-6

__all__ = ["rt_matrix", "so3_hat", "se3_hat", "so3_exp", "se3_exp", "se3_log"]


def rt_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Packs (..., 3, 3) rotations + (..., 3) translations into (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # made on the device (a tensor from a Python list would be a host copy)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) matrices of (..., 3) axis-angle vectors."""
    if omega.shape[-1] != 3:
        raise ValueError(f"omega must be (..., 3), got {tuple(omega.shape)}")
    ox, oy, oz = omega.unbind(-1)
    zero = torch.zeros_like(ox)
    hat = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], dim=-1)
    return hat.reshape(omega.shape[:-1] + (3, 3))


def se3_hat(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) hat operator for (..., 6) twists ``[v, omega]``."""
    if xi.shape[-1] != 6:
        raise ValueError(f"xi must be (..., 6), got {tuple(xi.shape)}")
    top = torch.cat([so3_hat(xi[..., 3:]), xi[..., :3, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def _rodrigues_terms(omega: torch.Tensor):
    """Rodrigues coefficients with small-angle-safe gradients.

    Returns (omega_hat, omega_hat_sq, A, B, C, is_small); ``theta`` is
    guarded (1 in the small branch, whose values ``where`` discards) so the
    backward pass never divides by zero.
    """
    omega_hat = so3_hat(omega)
    omega_hat_sq = matmul_small(omega_hat, omega_hat)
    theta_sq = (omega * omega).sum(-1)
    is_small = theta_sq < _EPS * _EPS
    theta = torch.sqrt(torch.where(is_small, torch.ones_like(theta_sq), theta_sq))
    s, c = torch.sin(theta), torch.cos(theta)
    A = s / theta
    B = (1.0 - c) / (theta * theta)
    C = (theta - s) / (theta * theta * theta)
    return omega_hat, omega_hat_sq, A, B, C, is_small


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map (..., 3) -> (..., 3, 3): ``I + A hat + B hat^2``
    (``I + hat`` for small angles)."""
    omega_hat, omega_hat_sq, A, B, _, is_small = _rodrigues_terms(omega)
    A_ = torch.where(is_small, torch.ones_like(A), A)[..., None, None]
    B_ = torch.where(is_small, torch.zeros_like(B), B)[..., None, None]
    return _eye3(omega_hat) + A_ * omega_hat + B_ * omega_hat_sq


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map of (..., 6) twists ``[v, omega]`` to (..., 4, 4).

    ``R = I + A hat + B hat^2``, ``V = I + B hat + C hat^2``, ``t = V v``;
    the small-angle branch sets both R and V to ``I + hat``.
    """
    if xi.shape[-1] != 6:
        raise ValueError(f"xi must be (..., 6), got {tuple(xi.shape)}")
    v = xi[..., :3]
    omega_hat, omega_hat_sq, A, B, C, is_small = _rodrigues_terms(xi[..., 3:])
    eye = _eye3(omega_hat)
    A_ = torch.where(is_small, torch.ones_like(A), A)[..., None, None]
    B_r = torch.where(is_small, torch.zeros_like(B), B)[..., None, None]
    R = eye + A_ * omega_hat + B_r * omega_hat_sq
    B_v = torch.where(is_small, torch.ones_like(B), B)[..., None, None]
    C_v = torch.where(is_small, torch.zeros_like(C), C)[..., None, None]
    V = eye + B_v * omega_hat + C_v * omega_hat_sq
    return rt_matrix(R, matvec(V, v))


def se3_log(transform: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Logarithm map (..., 4, 4) -> (..., 6) twists; inverse of
    :func:`se3_exp` away from theta = pi."""
    if tuple(transform.shape[-2:]) != (4, 4):
        raise ValueError(f"transform must be (..., 4, 4), got {tuple(transform.shape)}")
    R = transform[..., :3, :3]
    t = transform[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos_theta)
    is_small = theta < _EPS
    theta_safe = torch.where(is_small, torch.ones_like(theta), theta)
    coeff = torch.where(
        is_small,
        torch.full_like(theta, 0.5),
        theta_safe / (2.0 * torch.sin(theta_safe)),
    )[..., None, None]
    w_hat = coeff * (R - R.transpose(-1, -2))
    omega = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], dim=-1)
    omega_hat = so3_hat(omega)
    omega_hat_sq = matmul_small(omega_hat, omega_hat)
    A = torch.sin(theta_safe) / theta_safe
    B = (1.0 - torch.cos(theta_safe)) / (theta_safe * theta_safe)
    coef2 = torch.where(
        is_small,
        torch.full_like(theta, 1.0 / 12.0),
        (1.0 - A / (2.0 * B)) / (theta_safe * theta_safe),
    )[..., None, None]
    Vinv = _eye3(R) - 0.5 * omega_hat + coef2 * omega_hat_sq
    return torch.cat([matvec(Vinv, t), omega], dim=-1)
