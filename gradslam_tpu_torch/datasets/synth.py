"""Synthetic RGB-D sequence renderer (zero-egress benchmark data).

Ray-casts a smooth textured height-field surface from arbitrary camera
poses — the long-horizon, loop-rich stand-in for real TUM/ScanNet
sequences on a machine with no dataset access (the reference validates
against real datasets, gradslam tests/datasets/test_tum.py:14-17;
this renderer is the closest possible surrogate: exact ground-truth
poses, exact depth, loop-closure revisits).

The surface is a multi-frequency height field z = f(x, y) with slopes
well below 1 and a 3-channel procedural texture. Rays are cast by
fixed-point iteration on the ray parameter (converges geometrically for
|grad f| < 1 and view directions bounded away from grazing), so depth is
exact to float tolerance — no mesh, no sampling artifacts.

Poses use the same convention as the rest of the library: world-from-
camera, camera looks along +z.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "surface_height",
    "surface_texture",
    "render_frames",
    "loop_trajectory",
    "render_loop_sequence",
]


def _trig(x):
    """(sin, cos) of the array library of ``x``: numpy, or torch for a
    tensor (so a renderer on the card can sample the same surface)."""
    if type(x).__module__.startswith("torch"):
        import torch

        return torch.sin, torch.cos
    return np.sin, np.cos


def surface_height(x, y):
    """Height field z = f(x, y): smooth, textured, |slope| ~< 1.

    The high-frequency term carries most of the slope budget on purpose:
    point-to-plane ICP's lateral constraint scales with surface slope
    (a depth bias of e maps to lateral ambiguity ~ e/slope), so shallow
    geometry makes loop-closure verification converge to its seed
    instead of the true alignment (measured during round 4 — see
    tools/bench_loop.py).
    """
    sin, cos = _trig(x)
    return (
        3.0
        + 0.25 * sin(1.7 * x + 0.5) * cos(1.9 * y)
        + 0.15 * sin(0.9 * y + 1.0)
        + 0.09 * sin(5.1 * x + 2.0) * cos(4.7 * y + 0.7)
    )


def surface_texture(x, y):
    """RGB texture sampled at world (x, y), values in [0, 1]."""
    sin, cos = _trig(x)
    channels = [
        0.5 + 0.35 * sin(3.0 * x) + 0.1 * sin(11.0 * x + 2 * y),
        0.5 + 0.35 * cos(2.0 * y + 1.0) + 0.1 * cos(9.0 * y - x),
        0.5 + 0.35 * sin(1.3 * (x + y)) + 0.1 * sin(7.0 * (x - y)),
    ]
    if sin is np.sin:
        return np.stack(channels, axis=-1)
    import torch

    return torch.stack(channels, dim=-1)


def render_frames(
    poses: np.ndarray,
    H: int,
    W: int,
    intrinsics: Tuple[float, float, float, float],
    iters: int = 40,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-casts the surface from each pose.

    Args:
        poses: (N, 4, 4) world-from-camera transforms. Rotations must
            keep every pixel ray's world-z component positive (camera
            roughly facing the surface below).
        intrinsics: (fx, fy, cx, cy).

    Returns:
        (colors f32 (N, H, W, 3) in [0, 1], depths f32 (N, H, W) —
        camera-frame z depth, exactly what a depth camera stores).
    """
    fx, fy, cx, cy = intrinsics
    u = np.arange(W, dtype=np.float64)
    v = np.arange(H, dtype=np.float64)
    dxc = np.broadcast_to((u[None, :] - cx) / fx, (H, W))
    dyc = np.broadcast_to((v[:, None] - cy) / fy, (H, W))
    dc = np.stack([dxc, dyc, np.ones_like(dxc)], axis=-1)  # (H, W, 3)

    colors, depths = [], []
    for T in poses:
        R, t = T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)
        d = dc @ R.T  # (H, W, 3) world-frame ray directions
        dz = d[..., 2]
        if np.any(dz <= 0.05):
            raise ValueError(
                "a pixel ray points away from the surface (world dz "
                f"{dz.min():.3f}); reduce tilt/roll"
            )
        # fixed point on the ray parameter s (camera-frame z depth):
        # t_z + s*dz = f(t_x + s*dx, t_y + s*dy)
        s = np.full((H, W), 3.0)
        for _ in range(iters):
            s = (
                surface_height(t[0] + s * d[..., 0], t[1] + s * d[..., 1])
                - t[2]
            ) / dz
        x_w = t[0] + s * d[..., 0]
        y_w = t[1] + s * d[..., 1]
        depths.append(s.astype(np.float32))
        colors.append(surface_texture(x_w, y_w).astype(np.float32))
    return np.stack(colors), np.stack(depths)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def loop_trajectory(
    n_frames: int,
    radius: float = 0.55,
    roll_amp: float = 0.18,
    tilt_amp: float = 0.06,
    height_amp: float = 0.05,
    cycles: int = 1,
) -> np.ndarray:
    """A loop trajectory that REVISITS its start: a circle in the (x, y)
    plane with sinusoidal roll (about the optical axis), tilt and height
    modulation. The final pose returns to the first pose's neighborhood —
    a genuine loop-closure opportunity after ``n_frames`` of drift
    accumulation.

    Roll/tilt periods divide the loop, so frame 0 and frame N-1 differ
    only by the closing gap (~one frame step).

    Returns:
        (n_frames, 4, 4) float32 world-from-camera poses.
    """
    poses = []
    for k in range(n_frames):
        th = 2.0 * np.pi * cycles * k / n_frames
        t = np.array(
            [
                radius * (np.cos(th) - 1.0),
                radius * np.sin(th),
                height_amp * np.sin(3.0 * th),
            ]
        )
        R = (
            _rot_z(roll_amp * np.sin(2.0 * th))
            @ _rot_x(tilt_amp * np.sin(th))
            @ _rot_y(tilt_amp * np.cos(2.0 * th))
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses).astype(np.float32)


def render_loop_sequence(
    n_frames: int = 120,
    H: int = 120,
    W: int = 160,
    radius: float = 0.55,
    depth_noise: float = 0.0,
    seed: int = 0,
):
    """Renders the standard long-horizon loop benchmark sequence.

    Args:
        depth_noise: amplitude of a LOW-FREQUENCY multiplicative depth
            warp (fraction of depth; e.g. 0.003). Each frame draws random
            phases for a smooth sinusoidal bias field — the structured
            (calibration/warm-up-like) error real depth cameras exhibit.
            Smooth bias keeps normals clean (white per-pixel noise would
            destroy the normal gates and saturate the map) while biasing
            each frame's ICP slightly differently, so odometry drift
            ACCUMULATES over the loop — without it the synthetic depth is
            exact and drift is unmeasurably small, which would make the
            loop-closure rows of the benchmark meaningless.

    Returns:
        (colors (1, N, H, W, 3) f32 in [0, 255], depths (1, N, H, W, 1),
        intrinsics (1, 1, 4, 4), poses (1, N, 4, 4)) — batch-1 arrays in
        the library's native layouts, poses rebased so pose 0 = identity
        (the TUM loader convention, datasets/tum.py).
    """
    fx = fy = 525.0 * W / 640.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    poses = loop_trajectory(n_frames, radius=radius)
    colors, depths = render_frames(poses, H, W, (fx, fy, cx, cy))
    if depth_noise:
        rng = np.random.default_rng(seed)
        u = np.linspace(0.0, 2.0 * np.pi, W, dtype=np.float32)[None, :]
        v = np.linspace(0.0, 2.0 * np.pi, H, dtype=np.float32)[:, None]
        fields = []
        for _ in range(n_frames):
            ph = rng.uniform(0, 2 * np.pi, size=4).astype(np.float32)
            amp = rng.uniform(0.5, 1.0, size=2).astype(np.float32)
            fields.append(
                amp[0] * np.sin(u + ph[0]) * np.cos(v + ph[1])
                + amp[1] * np.sin(2 * u + ph[2])
                + 0.3 * np.cos(v + ph[3])
            )
        warp = np.stack(fields).astype(np.float32)  # (N, H, W), O(1)
        depths = depths * (1.0 + depth_noise * warp)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    # rebase: world frame = first camera frame
    T0inv = np.linalg.inv(poses[0].astype(np.float64))
    poses = (T0inv[None] @ poses.astype(np.float64)).astype(np.float32)
    return (
        (colors * 255.0)[None].astype(np.float32),
        depths[None, ..., None].astype(np.float32),
        K[None, None],
        poses[None],
    )
