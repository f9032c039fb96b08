"""ICP-SLAM with loop closure, written out plainly for one device: the
benchmark's reference for the ``icpslam-loopclosure-*`` configurations.

The algorithms are upstream gradslam's ``ICPSLAM`` (``slam/icpslam.py``:
gradICP odometry, aggregate mapping) and the loop closure that
``gradslam_tpu_torch/slam/loopclosure.py``'s docstrings describe: two
detectors over the whole trajectory, ICP verification of their candidates,
and a pose graph of odometry and loop edges. Each batch element runs on its
own, frame by frame, then is closed.

- **Mapping** appends every valid pixel of a frame, in pixel order, as a
  row ``[point, normal, colour, confidence weight]`` in the world frame
  (:func:`.pointfusion.frame_maps`); nothing is fused.
- **Odometry** aligns every ``dsratio``-th pixel of the new frame, placed at
  the last pose, to the *recent* targets: the rows the last frame appended,
  projected at the last pose, those on the ``dsratio`` pixel grid, in slot
  order, cut at ``4*ceil(H/ds)*ceil(W/ds)`` rounded up to a multiple of 1024.
  The solver is gradLM (:func:`.pointfusion.gradicp`) against each source's
  exact nearest target.
- **Closure** (:func:`close`): camera-frame clouds of every ``dsratio``-th
  pixel, back-projected through upstream's inverse intrinsics; the invariant descriptor (:func:`descriptors`); the pose detector
  (pairs ``j - i >= min_separation`` whose poses lie within
  ``max_distance`` and ``max_angle``, closest first) and the appearance
  detector (descriptors within an RMS of ``max_descriptor_dist``, most
  similar first), each taking its ``max_candidates`` best, equal scores in
  index order; each candidate ``(i, j)`` aligns frame j's cloud to frame
  i's by gradLM, seeded with the trajectory's ``T_i^-1 T_j`` for the pose
  detector and with each of seven rotations about the camera's y axis for
  the appearance detector (its association gated at ``3*inlier_dist`` on
  the squared distance, the best seed by inlier share kept), and is
  accepted where at least ``min_inlier_frac`` of frame j's valid points land
  within ``inlier_dist`` of their nearest point of frame i; a pair accepted
  by both detectors counts once (the pose detector's); the pose graph
  (:func:`pose_graph`) then refines the trajectory.

Departures from the published descriptions, each as the system under test
defines the step:

- ``'recent'`` targets (the last frame's appends only) in place of
  upstream's whole map, so that a frame's odometry does not grow with the
  map;
- the appearance descriptor's subsample is ``n_sample`` picks at
  ``floor(lin * (count - 1))`` of the frame's valid points in index order,
  with ``lin`` the float32 ``k * (1 / (n_sample - 1))`` (last entry exactly
  1), and its pairwise differences carry ``+1e-12`` on every coordinate;
- the descriptor's centroid is the sum of the sampled points over the
  frame's count of *all* valid points, not their mean;
- the pose graph's gauge is a prior of weight 1e6 on pose 0's perturbation
  and every iteration adds 1e-6 to the diagonal.

Products go through :func:`.pointfusion._mm`, which the control
(:func:`.precision.tf32_products`) runs on TF32 operands, and so does the
nearest neighbour. The Jacobians of the pose graph are the closed forms of
SE(3)'s adjoint and inverse right Jacobian (to fourth order in the
residual), not derivatives of the code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .pointfusion import Options, _apply, _exp, _mm, _nearest, _project, _solve, _strided_points, frame_maps, gradicp

YAWS = (0.0, 0.5236, -0.5236, 1.0472, -1.0472, 1.5708, -1.5708)


@dataclass(frozen=True)
class Closure:
    """Loop closure's parameters: the system's defaults."""

    max_candidates: int = 8
    min_separation: int = 5
    max_distance: float = 0.5
    max_angle: float = 1.0472
    icp_numiters: int = 20
    inlier_dist: float = 0.05
    min_inlier_frac: float = 0.5
    refine_iters: int = 10
    dsratio: int = 4
    max_descriptor_dist: float = 0.25
    n_sample: int = 128
    bins: int = 16
    detection: str = "both"


# --- odometry and mapping ------------------------------------------------------


def _recent_targets(rows, start: int, pose, K, H: int, W: int, ds: int):
    """The rows appended from slot ``start`` on that project onto the
    ``ds`` pixel grid at ``pose``, in slot order, cut at the target buffer's
    size."""
    cap = max(1024, -(-4 * -(-H // ds) * -(-W // ds) // 1024) * 1024)
    recent = rows[start:]
    row, col, inside = _project(recent[:, 0:3], pose, K, H, W)
    on = inside & (row % ds == 0) & (col % ds == 0)
    return recent[on][:cap]


def odometry_and_map(rgb, depth, K, opts: Options):
    """One (L, H, W, .) sequence mapped by appends with recent-target
    odometry. Returns (poses (L, 4, 4), map rows (n, 10))."""
    H, W = depth.shape[1:3]
    pose = torch.eye(4, dtype=depth.dtype, device=depth.device)
    frame = frame_maps(rgb[0], depth[0], K, pose, opts.sigma)
    rows, start, poses = frame.rows[frame.valid], 0, [pose]
    for t in range(1, depth.shape[0]):
        src, src_w = _strided_points(depth[t], K, pose, opts.dsratio)
        tgt = _recent_targets(rows, start, pose, K, H, W, opts.dsratio)
        pose = _mm(gradicp(src, src_w, tgt[:, 0:3], tgt[:, 3:6], opts), pose)
        frame = frame_maps(rgb[t], depth[t], K, pose, opts.sigma)
        start = rows.shape[0]
        rows = torch.cat([rows, frame.rows[frame.valid]])
        poses.append(pose)
    return torch.stack(poses), rows


# --- closure: clouds and descriptors ---------------------------------------------


def _camera_maps(depth, K):
    """Camera-frame vertex and normal maps of an (H, W, 1) depth frame:
    upstream's back-projection ``d * K^-1 [u, v, 1]`` with its inverse
    ``1 / (f + 1e-6)``, normals ``cross(d/du, d/dv)`` by forward differences
    (last column and row repeated), zero where the two are parallel."""
    H, W = depth.shape[:2]
    d = depth[..., 0]
    valid = d > 0
    kx, ky = 1.0 / (K[0, 0] + 1e-6), 1.0 / (K[1, 1] + 1e-6)
    ox, oy = -K[0, 2] / (K[0, 0] + 1e-6), -K[1, 2] / (K[1, 1] + 1e-6)
    u = torch.arange(W, dtype=d.dtype, device=d.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=d.dtype, device=d.device)[:, None].expand(H, W)
    ray = torch.stack([kx * u + ox, ky * v + oy, torch.ones_like(u)], dim=-1)
    vertex = ray * depth * valid[..., None]
    du = vertex[:, 1:] - vertex[:, :-1]
    du = torch.cat([du, du[:, -1:]], dim=1)
    dv = vertex[1:] - vertex[:-1]
    dv = torch.cat([dv, dv[-1:]], dim=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    nn2 = (n * n).sum(-1, keepdim=True)
    flat = nn2 <= 1e-12 * (du * du).sum(-1, keepdim=True) * (dv * dv).sum(-1, keepdim=True)
    n = torch.where(flat, torch.zeros_like(n), n / torch.sqrt(torch.where(flat, torch.ones_like(nn2), nn2)))
    return vertex, n * valid[..., None], valid


def clouds(depth, K, ds: int):
    """Camera-frame (points, normals, valid) of every ``ds``-th pixel of each
    frame, normals taken at full resolution: (L, N, 3), (L, N, 3), (L, N)."""
    out = [tuple(x[::ds, ::ds].reshape(-1, *x.shape[2:]) for x in _camera_maps(d, K)) for d in depth]
    return tuple(torch.stack(x) for x in zip(*out))


def _histogram(x, w, lo: float, hi: float, bins: int):
    """Each frame's histogram of the (L, P) values ``x`` weighted by ``w``
    over [lo, hi) in ``bins`` bins (values outside fall in the end bins),
    normalized to sum 1."""
    scale = torch.full((), 1.0 / (hi - lo), dtype=x.dtype, device=x.device)
    ix = torch.clamp(torch.floor((x - lo) * scale * bins), 0, bins - 1).long()
    onehot = (ix[..., None] == torch.arange(bins, device=x.device)).to(x.dtype)
    h = (onehot * w[..., None]).sum(-2)
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1e-12)


def descriptors(points, normals, valid, n_sample: int, bins: int):
    """The viewpoint-invariant descriptor of each of L frames' (N, 3)
    camera-frame points: histograms of its sampled points' pairwise
    distances, normal-to-normal cosines, |cosine| between a normal and the
    chord to the partner point, and distances to the centroid; distances
    over the sequence's mean pairwise distance (and mean centroid distance).
    Returns (L, 4 * bins)."""
    dtype, dev, eps = points.dtype, points.device, 1e-12
    L = points.shape[0]
    count = valid.sum(-1)
    step = torch.full((), 1.0 / (n_sample - 1), dtype=dtype, device=dev)
    lin = torch.cat([torch.arange(n_sample - 1, dtype=dtype, device=dev) * step, torch.ones(1, dtype=dtype, device=dev)])
    p, n, sv = [], [], []
    for t in range(L):
        idx = valid[t].nonzero()[:, 0]
        pos = torch.floor(lin * (count[t] - 1).clamp(min=0).to(dtype)).long()
        pick = idx[pos.clamp(max=max(idx.shape[0] - 1, 0))] if idx.shape[0] else torch.zeros_like(pos)
        p.append(points[t][pick])
        n.append(normals[t][pick])
        sv.append(torch.arange(n_sample, device=dev) < count[t])
    p, n, sv = torch.stack(p), torch.stack(n), torch.stack(sv)
    svf = sv.to(dtype)
    pair = sv[:, :, None] & sv[:, None, :] & ~torch.eye(n_sample, dtype=torch.bool, device=dev)
    wpair = pair.to(dtype).reshape(L, -1)
    chord = p[:, :, None, :] - p[:, None, :, :] + eps
    dist = torch.sqrt((chord * chord).sum(-1))
    alpha = ((chord * n[:, :, None, :]).sum(-1)).abs() / torch.clamp(dist, min=eps)
    ndot = torch.clamp((n[:, :, None, :] * n[:, None, :, :]).sum(-1), -1.0, 1.0).reshape(L, -1)
    centroid = (p * svf[..., None]).sum(-2) / torch.clamp(count.to(dtype), min=1.0)[:, None]
    off = p - centroid[:, None, :] + eps
    dc = torch.sqrt((off * off).sum(-1))
    dist, alpha = dist.reshape(L, -1), alpha.reshape(L, -1)
    scale = (dist * wpair).sum((-2, -1)) / torch.clamp(wpair.sum((-2, -1)), min=1.0)
    scale_c = (dc * svf).sum((-2, -1)) / torch.clamp(svf.sum((-2, -1)), min=1.0)
    return torch.cat([_histogram(dist / torch.clamp(scale, min=eps), wpair, 0.0, 3.0, bins),
                      _histogram(ndot, wpair, -1.0, 1.0, bins),
                      _histogram(alpha, wpair, 0.0, 1.0, bins),
                      _histogram(dc / torch.clamp(scale_c, min=eps), svf, 0.0, 3.0, bins)], dim=-1)


# --- closure: detection and verification -----------------------------------------


def _best(score, k: int):
    """The ``k`` best pairs (i, j) of an (L, L) score (``-inf``: no pair),
    equal scores in index order: [(i, j)] of the finite ones."""
    L = score.shape[0]
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    return [(int(q) // L, int(q) % L) for s, q in zip(top[:k].tolist(), idx[:k].tolist()) if math.isfinite(s)]


def detect_by_pose(poses, c: Closure):
    """The pose detector's candidates of an (L, 4, 4) trajectory, closest first."""
    L = poses.shape[0]
    t, R = poses[:, :3, 3], poses[:, :3, :3]
    d = t[:, None, :] - t[None, :, :]
    dist = torch.sqrt((d * d).sum(-1))
    rel = (R[:, None, :, :, None] * R[None, :, :, None, :]).sum(-3)  # R_i^T R_j
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    angle = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    sep = torch.arange(L, device=poses.device)[None, :] - torch.arange(L, device=poses.device)[:, None]
    ok = (sep >= c.min_separation) & (dist < c.max_distance) & (angle < c.max_angle)
    return _best(torch.where(ok, -dist, -math.inf), c.max_candidates)


def detect_by_appearance(desc, c: Closure):
    """The appearance detector's candidates of (L, D) descriptors, most similar first."""
    L = desc.shape[0]
    d = desc[:, None, :] - desc[None, :, :]
    rms = torch.sqrt((d * d).mean(-1))
    sep = torch.arange(L, device=desc.device)[None, :] - torch.arange(L, device=desc.device)[:, None]
    ok = (sep >= c.min_separation) & (rms < c.max_descriptor_dist)
    return _best(torch.where(ok, -rms, -math.inf), c.max_candidates)


def _gated_gradicp(src, tgt, tgt_n, T0, gate, opts: Options, numiters: int):
    """gradLM of the (S, 3) sources from the seed ``T0`` onto the targets,
    each source weighted 1 where its nearest target's squared distance is
    below ``gate`` (None: everywhere): the (4, 4) transform."""

    def rows(s):
        j = _nearest(s, tgt)
        d, nrm = tgt[j], tgt_n[j]
        w = torch.ones_like(s[:, 0])
        if gate is not None:
            w = (((s - d) ** 2).sum(-1) < gate).to(s.dtype)
        A = torch.cat([nrm, torch.linalg.cross(s, nrm, dim=-1)], dim=-1)
        return A, (nrm * (d - s)).sum(-1), w

    T, s = T0, _apply(T0, src)
    damp = torch.tensor(opts.damp, dtype=src.dtype, device=src.device)
    lmin = 1.0 / opts.lambda_max
    for _ in range(numiters):
        A, b, w = rows(s)
        xi = _solve(A, b, w, damp)
        _, b1, w1 = rows(_apply(_exp(xi), s))
        change = torch.clamp((w1 * b1 * b1).sum() - (w * b * b).sum(), -70.0, 70.0)
        damp = damp * (lmin + (opts.lambda_max - lmin) / (1.0 + torch.exp(-opts.B * change)))
        step = _exp(xi * (1.0 + torch.exp(-opts.B2 * change)) ** (-1.0 / opts.nu))
        s = _apply(step, s)
        T = _mm(step, T)
    return T


def _yaw(a: float, like):
    """The rotation by ``a`` radians about the camera's y axis, (4, 4)."""
    a = torch.full((), a, dtype=like.dtype, device=like.device)
    T = torch.eye(4, dtype=like.dtype, device=like.device)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = torch.cos(a), torch.sin(a), -torch.sin(a), torch.cos(a)
    return T


def _inverse(T):
    R = T[:3, :3].T
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3], out[:3, 3] = R, -_mm(R, T[:3, 3:4])[:, 0]
    return out


def verify(pairs, poses, pts, nrm, val, seeded: bool, c: Closure, opts: Options):
    """Each candidate (i, j): frame j's valid points aligned to frame i's by
    gradLM and scored by their share within ``inlier_dist`` of their
    nearest point of frame i. Returns [(i, j, Z_ij, accepted)]."""
    out = []
    for i, j in pairs:
        src, tgt, tgt_n = pts[j][val[j]], pts[i][val[i]], nrm[i][val[i]]
        if seeded:
            seeds, gate = [_mm(_inverse(poses[i]), poses[j])], None
        else:
            seeds, gate = [_yaw(a, poses) for a in YAWS], 3.0 * c.inlier_dist
        best = None
        for T0 in seeds:
            Z = _gated_gradicp(src, tgt, tgt_n, T0, gate, opts, c.icp_numiters)
            moved = _apply(Z, src)
            sq = ((moved - tgt[_nearest(moved, tgt)]) ** 2).sum(-1)
            frac = float((sq < c.inlier_dist**2).sum()) / max(1, src.shape[0])
            if best is None or frac > best[1]:
                best = (Z, frac)
        out.append((i, j, best[0], best[1] >= c.min_inlier_frac))
    return out


# --- closure: the pose graph ------------------------------------------------------


def _hat(w):
    """(n, 3) -> (n, 3, 3) skew matrices."""
    z = torch.zeros_like(w[:, 0])
    return torch.stack([z, -w[:, 2], w[:, 1], w[:, 2], z, -w[:, 0], -w[:, 1], w[:, 0], z], -1).reshape(-1, 3, 3)


def _exp_n(xi):
    """SE(3) exponential of (n, 6) twists ``[v, omega]``: (n, 4, 4),
    ``R = I + a W + b W^2``, ``t = (I + b W + c W^2) v`` (series below 0.1 rad,
    where float32 loses ``1 - cos``)."""
    w = xi[:, 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th < 0.1
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0 * (1.0 - th2 / 20.0), torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0 * (1.0 - th2 / 30.0), (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0 * (1.0 - th2 / 42.0), (ths - torch.sin(ths)) / (ths * ths * ths))
    W = _hat(w)
    W2 = _mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[:, None, None] * W + b[:, None, None] * W2
    V = eye + b[:, None, None] * W + c[:, None, None] * W2
    T = torch.eye(4, dtype=xi.dtype, device=xi.device).repeat(xi.shape[0], 1, 1)
    T[:, :3, :3], T[:, :3, 3] = R, _mm(V, xi[:, :3, None])[..., 0]
    return T


def _log_n(T):
    """SE(3) logarithm of (n, 4, 4) transforms: (n, 6) twists ``[v, omega]``
    (series below 0.1 rad for omega's scale and 0.5 rad for V^-1's)."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    s = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    th = torch.atan2(0.5 * torch.linalg.vector_norm(s, dim=-1), 0.5 * (R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0))
    th2 = th * th
    ths = torch.where(th < 0.1, torch.ones_like(th), th)
    w = torch.where(th < 0.1, 0.5 + th2 / 12.0 + 7.0 * th2 * th2 / 720.0, ths / (2.0 * torch.sin(ths)))[:, None] * s
    thl = torch.where(th < 0.5, torch.ones_like(th), th)
    k = torch.where(th < 0.5, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
                    (1.0 - thl * torch.sin(thl) / (2.0 * (1.0 - torch.cos(thl)))) / (thl * thl))
    Wh = _hat(w)
    Vinv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * Wh + k[:, None, None] * _mm(Wh, Wh)
    return torch.cat([_mm(Vinv, t[:, :, None])[..., 0], w], -1)


def _ad(xi):
    """(n, 6, 6) adjoint ``[[hat(w), hat(v)], [0, hat(w)]]`` of twists ``[v, w]``."""
    out = torch.zeros(xi.shape[0], 6, 6, dtype=xi.dtype, device=xi.device)
    out[:, :3, :3] = out[:, 3:, 3:] = _hat(xi[:, 3:])
    out[:, :3, 3:] = _hat(xi[:, :3])
    return out


def _edge_jacobian(r, Tj):
    """d r / d delta_j of ``r = log(Z^-1 T_i^-1 T_j)`` under ``T_j <-
    exp(delta_j) T_j``: ``Jr^-1(r) Ad(T_j^-1)``, with ``Jr^-1 = I + ad/2 +
    ad^2/12 - ad^4/720``; ``d r / d delta_i`` is its negative."""
    ad = _ad(r)
    ad2 = _mm(ad, ad)
    jr_inv = torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * ad + ad2 / 12.0 - _mm(ad2, ad2) / 720.0
    Rt = Tj[:, :3, :3].transpose(-1, -2)
    adj = torch.zeros(r.shape[0], 6, 6, dtype=r.dtype, device=r.device)
    adj[:, :3, :3] = adj[:, 3:, 3:] = Rt
    adj[:, :3, 3:] = -_mm(Rt, _hat(Tj[:, :3, 3]))
    return _mm(jr_inv, adj)


def pose_graph(poses, edges, Z, iters: int, anchor: float = 1e6, damping: float = 1e-6):
    """Gauss-Newton on (L, 4, 4) poses under left perturbations: residual
    ``log(Z_ij^-1 T_i^-1 T_j)`` of each edge (unit weights), the normal
    equations over all 6L unknowns as one dense matrix, solved directly."""
    L = poses.shape[0]
    i = torch.tensor([a for a, _ in edges], device=poses.device)
    j = torch.tensor([b for _, b in edges], device=poses.device)
    Zinv = torch.stack([_inverse(z) for z in Z])
    E = len(edges)
    edge = torch.arange(E, device=poses.device)
    for _ in range(iters):
        Ti_inv = torch.stack([_inverse(T) for T in poses[i]])
        r = _log_n(_mm(_mm(Zinv, Ti_inv), poses[j]))
        Jj = _edge_jacobian(r, poses[j])
        J = torch.zeros(E, 6, L, 6, dtype=poses.dtype, device=poses.device)
        J[edge, :, i] = -Jj
        J[edge, :, j] = Jj
        J = J.reshape(E * 6, L * 6)
        H = _mm(J.T, J) + damping * torch.eye(L * 6, dtype=poses.dtype, device=poses.device)
        H[:6, :6] += anchor * torch.eye(6, dtype=poses.dtype, device=poses.device)
        g = _mm(J.T, r.reshape(-1, 1))
        delta = torch.linalg.solve(H, -g)[:, 0].reshape(L, 6)
        poses = _mm(_exp_n(delta), poses)
    return poses


def close(rgb, depth, K, poses, opts: Options, c: Closure):
    """Loop closure of one (L, 4, 4) trajectory from its frames. Returns
    (refined poses, accepted pairs [(i, j)])."""
    pts, nrm, val = clouds(depth, K, c.dsratio)
    found = []
    if c.detection in ("pose", "both"):
        found += verify(detect_by_pose(poses, c), poses, pts, nrm, val, True, c, opts)
    if c.detection in ("appearance", "both"):
        desc = descriptors(pts, nrm, val, c.n_sample, c.bins)
        found += verify(detect_by_appearance(desc, c), poses, pts, nrm, val, False, c, opts)
    loops, seen = [], set()
    for i, j, Z, ok in found:
        if ok and (i, j) not in seen:
            seen.add((i, j))
            loops.append((i, j, Z))
    L = poses.shape[0]
    odo = [(t, t + 1, _mm(_inverse(poses[t]), poses[t + 1])) for t in range(L - 1)]
    edges = odo + loops
    refined = pose_graph(poses, [(a, b) for a, b, _ in edges], [z for _, _, z in edges], c.refine_iters)
    return refined, sorted(seen)


def sequence(rgb, depth, K, opts: Options, closure: Closure):
    """A whole (B, L, H, W, .) batch of sequences with (B, 1, 4, 4)
    pinholes, each mapped, tracked and closed on its own.

    Returns (refined poses (B, L, 4, 4), [each element's map rows (n, 10)],
    [each element's accepted loop pairs])."""
    poses, maps, pairs = [], [], []
    for b in range(rgb.shape[0]):
        Kb = K[b].reshape(4, 4)
        odo, rows = odometry_and_map(rgb[b], depth[b], Kb, opts)
        refined, accepted = close(rgb[b], depth[b], Kb, odo, opts, closure)
        poses.append(refined)
        maps.append(rows)
        pairs.append(accepted)
    return torch.stack(poses), maps, pairs

