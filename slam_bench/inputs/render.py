"""The frozen renderer: RGB-D frames of a camera circling a textured height
field, ray-cast in float64 on the device.

A copy of the port's synthetic scene (``datasets/synth.py``: the surface,
its texture and the loop trajectory) and of ``chip_smoke.py``'s ray-cast on
the card, kept here so that a change to either leaves the benchmark's
inputs as they are. The seed draws where each arc starts on the loop, the
phases of the camera's roll and tilt, and the phases and amplitudes of each
frame's low-frequency multiplicative depth warp (the structured error of a
real depth camera, which makes odometry drift). Every seed gives the same
sizes: only the content moves.

Poses are world-from-camera, the camera looks along +z, and each arc's
poses are rebased so that its first pose is the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROLL_AMP, TILT_AMP, HEIGHT_AMP = 0.18, 0.06, 0.05
RAY_ITERS = 40  # fixed-point steps of the ray-cast
FRAMES_PER_CALL = 16  # frames ray-cast together (bounds the float64 temporaries)


def surface_height(x, y):
    """Height field z = f(x, y): smooth, textured, |slope| below 1."""
    return (3.0 + 0.25 * torch.sin(1.7 * x + 0.5) * torch.cos(1.9 * y) + 0.15 * torch.sin(0.9 * y + 1.0)
            + 0.09 * torch.sin(5.1 * x + 2.0) * torch.cos(4.7 * y + 0.7))


def surface_texture(x, y):
    """RGB texture at world (x, y), values in [0, 1]."""
    return torch.stack([
        0.5 + 0.35 * torch.sin(3.0 * x) + 0.1 * torch.sin(11.0 * x + 2 * y),
        0.5 + 0.35 * torch.cos(2.0 * y + 1.0) + 0.1 * torch.cos(9.0 * y - x),
        0.5 + 0.35 * torch.sin(1.3 * (x + y)) + 0.1 * torch.sin(7.0 * (x - y)),
    ], dim=-1)


def _rot(axis: int, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def loop_poses(n_loop: int, start: int, count: int, radius: float, phases) -> np.ndarray:
    """``count`` float64 world-from-camera poses of the loop of ``n_loop``
    frames, from frame ``start`` on: a circle of ``radius`` with a roll
    about the optical axis, two tilts and a height that vary around it;
    ``phases`` (roll, tilt x, tilt y) shift those variations."""
    pr, px, py = phases
    out = np.empty((count, 4, 4))
    for k in range(count):
        th = 2.0 * math.pi * (start + k) / n_loop
        T = np.eye(4)
        T[:3, :3] = (_rot(2, ROLL_AMP * math.sin(2.0 * th + pr)) @ _rot(0, TILT_AMP * math.sin(th + px))
                     @ _rot(1, TILT_AMP * math.cos(2.0 * th + py)))
        T[:3, 3] = (radius * (math.cos(th) - 1.0), radius * math.sin(th), HEIGHT_AMP * math.sin(3.0 * th))
        out[k] = T
    return out


def intrinsics(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """The 4x4 pinhole matrix."""
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def _ray_cast(poses: np.ndarray, K: np.ndarray, H: int, W: int, dev):
    """(colors (N, H, W, 3) in [0, 1], z-depth (N, H, W)) float64 of the
    surface seen from each pose."""
    f64 = dict(dtype=torch.float64, device=dev)
    u = torch.arange(W, **f64)[None, :].expand(H, W)
    v = torch.arange(H, **f64)[:, None].expand(H, W)
    dc = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], torch.ones_like(u)], dim=-1)
    R = torch.as_tensor(poses[:, :3, :3], **f64)
    t = torch.as_tensor(poses[:, :3, 3], **f64)[:, None, None, :]
    d = (dc[None, :, :, None, :] * R[:, None, None]).sum(-1)  # world-frame ray directions
    if bool((d[..., 2] <= 0.05).any()):
        raise ValueError("a pixel ray points away from the surface")
    s = torch.full(d.shape[:3], 3.0, **f64)
    for _ in range(RAY_ITERS):
        s = (surface_height(t[..., 0] + s * d[..., 0], t[..., 1] + s * d[..., 1]) - t[..., 2]) / d[..., 2]
    return surface_texture(t[..., 0] + s * d[..., 0], t[..., 1] + s * d[..., 1]), s


def render_arcs(seed: int, arcs: int, length: int, H: int, W: int, pinhole, n_loop: int, radius: float,
                depth_noise: float, device):
    """``arcs`` arcs of ``length`` frames of the loop, drawn from ``seed``,
    seen through ``pinhole`` (fx, fy, cx, cy).

    Returns (colors (arcs, length, H, W, 3) float32 0-255, depths (arcs,
    length, H, W, 1) float32, intrinsics (arcs, 1, 4, 4) float32, rebased
    ground-truth poses (arcs, length, 4, 4) float32), all on ``device``.
    """
    rng = np.random.default_rng(seed)
    K = intrinsics(*pinhole)
    uu = torch.linspace(0.0, 2.0 * math.pi, W, dtype=torch.float32, device=device)[None, :]
    vv = torch.linspace(0.0, 2.0 * math.pi, H, dtype=torch.float32, device=device)[:, None]
    colors = torch.empty((arcs, length, H, W, 3), dtype=torch.float32, device=device)
    depths = torch.empty((arcs, length, H, W, 1), dtype=torch.float32, device=device)
    gt = np.empty((arcs, length, 4, 4))
    for a in range(arcs):
        start = int(rng.integers(n_loop))
        poses = loop_poses(n_loop, start, length, radius, rng.uniform(0.0, 2.0 * math.pi, size=3))
        ph = torch.as_tensor(rng.uniform(0.0, 2.0 * math.pi, size=(length, 4)), dtype=torch.float32, device=device)
        amp = torch.as_tensor(rng.uniform(0.5, 1.0, size=(length, 2)), dtype=torch.float32, device=device)
        for f0 in range(0, length, FRAMES_PER_CALL):
            sl = slice(f0, min(length, f0 + FRAMES_PER_CALL))
            rgb, s = _ray_cast(poses[sl], K, H, W, device)
            colors[a, sl] = (rgb * 255.0).float()
            p, m = ph[sl, :, None, None], amp[sl, :, None, None]
            warp = (m[:, 0] * torch.sin(uu + p[:, 0]) * torch.cos(vv + p[:, 1]) + m[:, 1] * torch.sin(2 * uu + p[:, 2])
                    + 0.3 * torch.cos(vv + p[:, 3]))
            depths[a, sl, ..., 0] = s.float() * (1.0 + depth_noise * warp)
        gt[a] = np.linalg.inv(poses[0])[None] @ poses
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device).expand(arcs, 1, 4, 4).contiguous()
    return colors, depths, Kt, torch.as_tensor(gt, dtype=torch.float32, device=device)
