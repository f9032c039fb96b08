"""PointFusion with gradICP odometry, written out plainly for one device:
the benchmark's reference for what its cells run.

The algorithms are upstream gradslam's (``slam/pointfusion.py``,
``slam/fusionutils.py``, ``odometry/icputils.py``) after the papers behind
them: point-based fusion (Keller et al., 3DV 2013) and gradLM, the smooth
Levenberg-Marquardt of gradSLAM (Jatavallabhula et al., ICRA 2020). They run
at the fixed sizes the configuration states: an arena of ``capacity`` rows,
fusion's active set of ``2*H*W`` rows and odometry's target set of
``4*ceil(H/ds)*ceil(W/ds)`` rows rounded up to a multiple of 1024, each
taken in slot order and cut where it is full.

Each batch element runs on its own, frame by frame. A map is a (n, 10)
tensor of rows ``[point(3), normal(3), colour(3), confidence]`` in the
world frame, appended in pixel order. Selections are ``nonzero`` and
``scatter_reduce`` as plain code writes them; nothing here avoids waiting on
the device. Products go through :func:`_mm`, which the control
(:func:`.precision.tf32_products`) runs on TF32 operands, and the nearest
neighbour takes the ``|s|^2 - 2 s.t + |t|^2`` form there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import precision


@dataclass(frozen=True)
class Options:
    """PointFusion's parameters: upstream gradslam's defaults."""

    dsratio: int = 4
    numiters: int = 20
    damp: float = 1e-8
    lambda_max: float = 2.0
    B: float = 1.0
    B2: float = 1.0
    nu: float = 200.0
    dist_th: float = 0.05
    angle_th: float = 20.0
    sigma: float = 0.6


class State(NamedTuple):
    """One batch element after a frame: its map rows, the frame's pose,
    the slots of the fusion step's active set and the first slot the frame
    appended."""

    rows: torch.Tensor
    pose: torch.Tensor
    active: torch.Tensor
    app_start: int


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (TF32 operands under the control)."""
    if precision.lowered():
        a, b = precision.tf32(a), precision.tf32(b)
    return a @ b


def _apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(n, 3) points moved by the rigid (4, 4) transform ``T``."""
    return _mm(points, T[:3, :3].T) + T[:3, 3]


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of the twist ``[v, omega]`` (Rodrigues), with
    gradslam's small-angle form ``R = V = I + hat(omega)`` below 1e-6 rad."""
    v, w = xi[:3], xi[3:]
    W = _hat(w)
    W2 = _mm(W, W)
    th2 = (w * w).sum()
    small = th2 < 1e-12
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / th)
    b = (1.0 - torch.cos(th)) / th2s
    c = torch.where(small, torch.zeros_like(th), (th - torch.sin(th)) / (th2s * th))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + torch.where(small, torch.zeros_like(b), b) * W2
    V = eye + torch.where(small, torch.ones_like(b), b) * W + c * W2
    top = torch.cat([R, _mm(V, v[:, None])], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=0)


def _project(points: torch.Tensor, pose: torch.Tensor, K: torch.Tensor, H: int, W: int):
    """Pixel (row, col) of each world point seen from ``pose`` and whether
    it falls in the frame (in front of the camera, ``-1e-3 < u < W - 0.999``
    and the same for v; rounded half to even and clamped)."""
    with torch.no_grad():
        cam = _mm(points - pose[:3, 3], pose[:3, :3])  # R^T (p - t), row by row
        uvw = _mm(cam, K[:3, :3].T)
        z = cam[:, 2]
        zs = torch.where(z != 0, z, torch.ones_like(z))
        u, v = uvw[:, 0] / zs, uvw[:, 1] / zs
        inside = (u > -1e-3) & (u < W - 0.999) & (v > -1e-3) & (v < H - 0.999) & (z > 0)
        row = torch.round(v).clamp(0, H - 1).long()
        col = torch.round(u).clamp(0, W - 1).long()
    return row, col, inside


class Frame(NamedTuple):
    """A frame's per-pixel maps, flattened in pixel order: world points and
    normals, validity, and the (H*W, 10) rows the frame would append
    (point, normal, colour, confidence weight alpha)."""

    points: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor
    rows: torch.Tensor


def frame_maps(rgb, depth, K, pose, sigma: float) -> Frame:
    """Back-projects one (H, W, 1) depth frame through the (4, 4) pinhole
    ``K`` and poses it: normals are ``cross(d/du, d/dv)`` of the vertex map
    by forward differences (last column and row repeated), zero where the
    two differences are parallel; alpha is ``exp(-|p|^2 / (2 sigma^2))``
    of the camera-frame point, clamped to [1e-7, 1.01]."""
    H, W = depth.shape[:2]
    d = depth[..., 0]
    valid = d > 0
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = torch.arange(W, dtype=d.dtype, device=d.device)[None, :]
    v = torch.arange(H, dtype=d.dtype, device=d.device)[:, None]
    local = torch.stack([d * (u - cx) / fx, d * (v - cy) / fy, d], dim=-1) * valid[..., None]
    du = local[:, 1:] - local[:, :-1]
    du = torch.cat([du, du[:, -1:]], dim=1)
    dv = local[1:] - local[:-1]
    dv = torch.cat([dv, dv[-1:]], dim=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    nn2 = (n * n).sum(-1, keepdim=True)
    flat = nn2 <= 1e-12 * (du * du).sum(-1, keepdim=True) * (dv * dv).sum(-1, keepdim=True)
    n = torch.where(flat, torch.zeros_like(n), n / torch.sqrt(torch.where(flat, torch.ones_like(nn2), nn2)))
    n = n * valid[..., None]
    local, n, valid = local.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1)
    points = _apply(pose, local) * valid[:, None]
    normals = _mm(n, pose[:3, :3].T)
    alpha = torch.exp(-(local * local).sum(-1) / (2 * sigma**2)).clamp(1e-7, 1.01)
    rows = torch.cat([points, normals, rgb.reshape(-1, 3), alpha[:, None]], dim=-1)
    return Frame(points, normals, valid, rows)


def _nearest(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Index of each (S, 3) source's nearest (T, 3) target by squared
    distance, exact in float32 (the first of equals)."""
    src, tgt = src.detach(), tgt.detach()
    chunk = max(1, (1 << 24) // max(1, tgt.shape[0]))
    out = []
    for s in src.split(chunk):
        if precision.lowered():
            d = (s * s).sum(-1)[:, None] - 2.0 * _mm(s, tgt.T) + (tgt * tgt).sum(-1)[None, :]
        else:
            d = ((s[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        out.append(d.argmin(dim=1))
    return torch.cat(out)


def _linearize(src, src_w, tgt, tgt_n):
    """Point-to-plane rows against each source's nearest target:
    ``A = [n, s x n]``, ``b = n . (d - s)`` and the rows' weights."""
    if tgt.shape[0] == 0:
        return torch.zeros_like(src).repeat(1, 2), torch.zeros_like(src[:, 0]), torch.zeros_like(src_w)
    j = _nearest(src, tgt)
    d, n = tgt[j], tgt_n[j]
    A = torch.cat([n, torch.linalg.cross(src, n, dim=-1)], dim=-1)
    b = (n * (d - src)).sum(-1)
    return A, b, src_w


def _solve(A, b, w, damp):
    Aw = (A * w[:, None]).T
    H = _mm(Aw, A) + damp * torch.eye(6, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(H, _mm(Aw, b[:, None]))[:, 0]


def gradicp(src, src_w, tgt, tgt_n, opts: Options) -> torch.Tensor:
    """The (4, 4) transform that aligns the (S, 3) sources (weights ``src_w``)
    to the (T, 3) targets with normals ``tgt_n``, by gradLM from the identity:
    each iteration solves the damped normal equations, measures the error a
    full step would leave, scales the damping by ``lmin + (lmax - lmin) /
    (1 + exp(-B d))`` and takes the step scaled by ``(1 + exp(-B2 d))^(-1/nu)``,
    where ``d`` is that error's change, clamped to [-70, 70]."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    damp = torch.tensor(opts.damp, dtype=src.dtype, device=src.device)
    lmin = 1.0 / opts.lambda_max
    for _ in range(opts.numiters):
        A, b, w = _linearize(src, src_w, tgt, tgt_n)
        xi = _solve(A, b, w, damp)
        err = (w * b * b).sum()
        _, b1, w1 = _linearize(_apply(_exp(xi), src), src_w, tgt, tgt_n)
        change = torch.clamp((w1 * b1 * b1).sum() - err, -70.0, 70.0)
        damp = damp * (lmin + (opts.lambda_max - lmin) / (1.0 + torch.exp(-opts.B * change)))
        step = _exp(xi * (1.0 + torch.exp(-opts.B2 * change)) ** (-1.0 / opts.nu))
        src = _apply(step, src)
        T = _mm(step, T)
    return T


def _winners(pix, conf, ray, slot, num_pixels: int) -> torch.Tensor:
    """Each pixel's winning slot among the candidates at it (-1 where none):
    the highest confidence, then the smallest squared ray distance, then the
    lowest slot."""
    conf, ray = conf.detach(), ray.detach()
    best = torch.full((num_pixels,), -math.inf, dtype=conf.dtype, device=conf.device)
    best = best.scatter_reduce(0, pix, conf, "amax")
    keep = conf == best[pix]
    nearest = torch.full((num_pixels,), math.inf, dtype=ray.dtype, device=ray.device)
    nearest = nearest.scatter_reduce(0, pix, torch.where(keep, ray, math.inf), "amin")
    keep = keep & (ray == nearest[pix])
    none = torch.iinfo(torch.int64).max
    first = torch.full((num_pixels,), none, dtype=torch.int64, device=pix.device)
    first = first.scatter_reduce(0, pix, torch.where(keep, slot, none), "amin")
    return torch.where(first == none, -1, first)


def fuse(rows, frame: Frame, pose, K, H: int, W: int, opts: Options, capacity: int):
    """One fusion step: the map rows that project into the frame at
    ``pose`` (the first ``2*H*W`` in slot order) are matched to the
    frame's point at their pixel where they lie within ``dist_th`` and
    their normals within ``angle_th``; each pixel's winner takes the
    confidence-weighted mean ``(c m + alpha f) / (c + alpha)`` of point,
    normal and colour, and confidence ``c + alpha``; every other valid
    pixel is appended, in pixel order, while the arena has room.

    Returns (rows, the active set's slots, the first appended slot)."""
    n = rows.shape[0]
    row, col, inside = _project(rows[:, 0:3], pose, K, H, W)
    active = inside.nonzero()[:, 0][: 2 * H * W]
    pix = row[active] * W + col[active]
    fp, fn = frame.points[pix], frame.normals[pix]
    mp, mn = rows[active, 0:3], rows[active, 3:6]
    with torch.no_grad():
        ok = (torch.sqrt(((fp - mp) ** 2).sum(-1)) < opts.dist_th) & (
            (fn * mn).sum(-1) > math.cos(math.radians(opts.angle_th)))
        ray = ((mp - fp) ** 2).sum(-1)
    win = _winners(pix[ok], rows[active[ok], 9], ray[ok], active[ok], H * W)
    wpix = (win >= 0).nonzero()[:, 0]
    wslot = win[wpix]
    m, f = rows[wslot], frame.rows[wpix]
    c, a = m[:, 9:10], f[:, 9:10]
    rows = rows.index_put((wslot,), torch.cat([(c * m[:, 0:9] + a * f[:, 0:9]) / (c + a), c + a], dim=-1))
    new = (frame.valid & (win < 0)).nonzero()[:, 0][: capacity - n]
    return torch.cat([rows, frame.rows[new]]), active, n


def _targets(state: State, K, H: int, W: int, opts: Options):
    """Odometry's targets: the last fusion step's active rows and the rows
    the last frame appended, as they stand now, that project onto the
    ``dsratio`` pixel grid at the last pose; the first ``4*ceil(H/ds)*ceil(W/ds)``,
    rounded up to a multiple of 1024."""
    ds = opts.dsratio
    cap = max(1024, -(-4 * -(-H // ds) * -(-W // ds) // 1024) * 1024)
    n = state.rows.shape[0]
    cand = torch.cat([state.active, torch.arange(state.app_start, n, device=state.rows.device)])
    row, col, inside = _project(state.rows[cand, 0:3], state.pose, K, H, W)
    on = inside & (row % ds == 0) & (col % ds == 0)
    return state.rows[cand[on][:cap]]


def init(rgb, depth, K, opts: Options, capacity: int) -> State:
    """The first (H, W, .) frame fused into an empty arena at the identity."""
    H, W = depth.shape[:2]
    pose = torch.eye(4, dtype=depth.dtype, device=depth.device)
    frame = frame_maps(rgb, depth, K, pose, opts.sigma)
    rows, active, app_start = fuse(frame.rows[:0], frame, pose, K, H, W, opts, capacity)
    return State(rows, pose, active, app_start)


def step(state: State, rgb, depth, K, opts: Options, capacity: int) -> State:
    """One frame: gradICP of the frame's points (every ``dsratio``-th pixel,
    placed at the last pose) against :func:`_targets`, then fusion at the
    new pose."""
    H, W = depth.shape[:2]
    src, src_w = _strided_points(depth, K, state.pose, opts.dsratio)
    tgt = _targets(state, K, H, W, opts)
    T = gradicp(src, src_w, tgt[:, 0:3], tgt[:, 3:6], opts)
    pose = _mm(T, state.pose)
    frame = frame_maps(rgb, depth, K, pose, opts.sigma)
    rows, active, app_start = fuse(state.rows, frame, pose, K, H, W, opts, capacity)
    return State(rows, pose, active, app_start)


def _strided_points(depth, K, pose, ds: int):
    """World points of every ``ds``-th pixel of the frame at ``pose`` and
    their validity as weights."""
    d = depth[::ds, ::ds, 0]
    u = torch.arange(0, depth.shape[1], ds, dtype=d.dtype, device=d.device)[None, :]
    v = torch.arange(0, depth.shape[0], ds, dtype=d.dtype, device=d.device)[:, None]
    valid = d > 0
    local = torch.stack([d * (u - K[0, 2]) / K[0, 0], d * (v - K[1, 2]) / K[1, 1], d], dim=-1) * valid[..., None]
    return _apply(pose, local.reshape(-1, 3)) * valid.reshape(-1, 1), valid.reshape(-1).to(d.dtype)


def sequence(rgb, depth, K, opts: Options, capacity: int):
    """A whole (B, L, H, W, .) batch of sequences with (B, 1, 4, 4) pinholes.

    Returns (poses (B, L, 4, 4), [each element's map rows (n, 10)])."""
    poses, maps = [], []
    for b in range(rgb.shape[0]):
        Kb = K[b].reshape(4, 4)
        s = init(rgb[b, 0], depth[b, 0], Kb, opts, capacity)
        p = [s.pose]
        for t in range(1, rgb.shape[1]):
            s = step(s, rgb[b, t], depth[b, t], Kb, opts, capacity)
            p.append(s.pose)
        poses.append(torch.stack(p))
        maps.append(s.rows)
    return torch.stack(poses), maps
