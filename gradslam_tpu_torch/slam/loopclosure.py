"""Loop closure: detection, ICP verification and pose-graph correction
(PyTorch port of gradslam_tpu.slam.loopclosure).

Odometry drift grows without bound over a long trajectory; closing loops
against revisited views removes it. Detection is a dense (L, L) test (pose
proximity, or the distance between pose-independent descriptors) and a
fixed count of candidates taken by score; verification runs ONE batched
gradICP solve over every candidate pair (its association is the KNN
kernel on the card) and scores each by its inlier fraction; correction is
the pose-graph Gauss-Newton of :mod:`..parallel.pose_refine`. Rejected and
padded candidates carry weight 0 through the pose graph, so every shape is
fixed and nothing waits on the host.

Candidates with equal scores are taken in ascending index order (a stable
descending sort), so the invalid slots, which still enter the ICP batch
and the pose graph with weight 0, are the same pairs on every device.

On a CUDA device the functions that the JAX package jits run as captured
CUDA graphs (``slam/stepgraph.graphed``, one per set of static arguments:
the shapes, dtypes and every non-tensor argument, float gates included):
:func:`close_loops_batched` (so :func:`close_loops`) and
:func:`close_loops_rgbd` each as one graph of detection, verification and
the pose graph, and :func:`detect_loop_closures`,
:func:`detect_loop_closures_descriptor`, :func:`keyframe_descriptors` and
:func:`keyframe_descriptors_invariant` each when called on its own.
:func:`verify_loop_closures` runs eagerly on its own (the JAX package does
not jit it at top level). Constants are made on the device by a fill, never
copied from the host: a capture refuses a copy from pageable memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry import inverse_transformation, relative_transformation, transform_pointcloud
from ..geometry.projutils import matmul_small
from ..odometry.icputils import point_to_plane_gradICP
from ..ops.knn import knn
from ..parallel.pose_refine import PoseGraph, pose_graph_refine
from .stepgraph import graphed

__all__ = [
    "LoopCandidates",
    "frame_clouds_from_rgbd",
    "keyframe_descriptors",
    "keyframe_descriptors_invariant",
    "detect_loop_closures",
    "detect_loop_closures_descriptor",
    "verify_loop_closures",
    "close_loops",
    "close_loops_batched",
    "close_loops_rgbd",
]

_DETECTIONS = ("pose", "appearance", "both")


class LoopCandidates(NamedTuple):
    """K candidate loop-closure pairs (fixed shape; invalid slots have
    ``valid = False``).

    Attributes:
        edges: (..., K, 2) int32 keyframe index pairs (i < j).
        valid: (..., K) bool.
    """

    edges: torch.Tensor
    valid: torch.Tensor


def _rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 3, 3) matrices (radians)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def _full(x: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor made on ``device`` by a fill (``torch.tensor(x,
    device=...)`` copies from the host, which a capture refuses)."""
    return torch.full((), x, dtype=dtype, device=device)


def _top_k(score: torch.Tensor, k: int):
    """The k largest of (..., n) scores and their indices, equal scores in
    ascending index order (``torch.topk`` leaves their order open)."""
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _top_candidates(score: torch.Tensor, L: int, max_candidates: int) -> LoopCandidates:
    """The ``max_candidates`` best of (..., L, L) scores: pairs ``(i, j)``
    and ``valid = isfinite(score)``."""
    top, idx = _top_k(score.reshape(score.shape[:-2] + (L * L,)), min(max_candidates, L * L))
    edges = torch.stack([idx // L, idx % L], dim=-1).to(torch.int32)
    return LoopCandidates(edges=edges, valid=torch.isfinite(top))


def _separation(L: int, device) -> torch.Tensor:
    ar = torch.arange(L, device=device)
    return ar[None, :] - ar[:, None]  # j - i


def detect_loop_closures(
    poses: torch.Tensor,
    max_candidates: int = 8,
    min_separation: int = 5,
    max_distance: float = 0.5,
    max_angle: float = 1.0472,  # 60 degrees
) -> LoopCandidates:
    """Finds keyframe pairs whose (drifted) poses revisit the same view.

    Dense (L, L) proximity test: translation distance below
    ``max_distance``, relative rotation below ``max_angle`` and a temporal
    separation of at least ``min_separation`` frames; the
    ``max_candidates`` closest pairs are taken.

    Args:
        poses: (..., L, 4, 4) world-from-keyframe poses.

    Returns:
        LoopCandidates with (..., K, 2) index pairs, i < j.
    """
    return graphed("detect_loop_closures", _detect_loop_closures, (poses,), max_candidates=max_candidates,
                   min_separation=min_separation, max_distance=max_distance, max_angle=max_angle)


def _detect_loop_closures(poses, max_candidates, min_separation, max_distance, max_angle):
    L = poses.shape[-3]
    t = poses[..., :3, 3]
    diff = t[..., :, None, :] - t[..., None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1))  # (..., L, L)
    R = poses[..., :3, :3]
    # R_i^T R_j as a multiply-and-sum
    rel = (R[..., :, None, :, :, None] * R[..., None, :, :, None, :]).sum(-3)
    rel_ang = _rotation_angle(rel)
    sep = _separation(L, poses.device)
    ok = (sep >= min_separation) & (dist < max_distance) & (rel_ang < max_angle)
    score = torch.where(ok, -dist, torch.full_like(dist, -torch.inf))
    return _top_candidates(score, L, max_candidates)


def keyframe_descriptors(
    depth: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    grid: Tuple[int, int] = (6, 8),
) -> torch.Tensor:
    """Pose-independent per-keyframe appearance and geometry descriptor.

    A coarse ``grid`` of (masked mean depth over the frame's median valid
    depth, masked mean camera-frame normal, valid-coverage fraction) per
    cell: untouched by pose drift, every component dimensionless. Grid
    cells do not correspond under a change of viewpoint: for revisits at
    another yaw use :func:`keyframe_descriptors_invariant`.

    Args:
        depth: (..., L, H, W) metric depth; normals: (..., L, H, W, 3)
            camera-frame unit normals; valid: (..., L, H, W) bool.
        grid: (gh, gw) descriptor resolution.

    Returns:
        (..., L, gh*gw*5) descriptors.
    """
    return graphed("keyframe_descriptors", _keyframe_descriptors, (depth, normals, valid), grid=tuple(grid))


def _keyframe_descriptors(depth, normals, valid, grid):
    lead = depth.shape[:-2]
    H, W = depth.shape[-2:]
    depth = depth.reshape(-1, H, W)
    normals = normals.reshape(-1, H, W, 3)
    valid = valid.reshape(-1, H, W)
    L = depth.shape[0]
    gh, gw = grid
    Hc, Wc = (H // gh) * gh, (W // gw) * gw
    cell = (Hc // gh) * (Wc // gw)

    d = depth[:, :Hc, :Wc].reshape(L, gh, Hc // gh, gw, Wc // gw)
    v = valid[:, :Hc, :Wc].reshape(L, gh, Hc // gh, gw, Wc // gw)
    n = normals[:, :Hc, :Wc].reshape(L, gh, Hc // gh, gw, Wc // gw, 3)
    vf = v.to(depth.dtype)
    cnt = vf.sum((2, 4))  # (L, gh, gw)
    denom = torch.clamp(cnt, min=1.0)
    mean_d = (d * vf).sum((2, 4)) / denom
    mean_n = (n * vf[..., None]).sum((2, 4)) / denom[..., None]
    # the reference's division by the constant cell size is a multiply by
    # its reciprocal
    frac = cnt * _full(1.0 / cell, depth.dtype, depth.device)

    # per-frame median valid depth (masked median via sort)
    flat_d = depth.reshape(L, -1)
    flat_v = valid.reshape(L, -1)
    nvalid = flat_v.sum(-1)
    sorted_d = torch.sort(torch.where(flat_v, flat_d, torch.full_like(flat_d, torch.inf)), dim=-1)[0]
    mid = torch.clamp(nvalid - 1, min=0) // 2
    med = torch.gather(sorted_d, 1, mid[:, None])[:, 0]
    med = torch.where((nvalid > 0) & torch.isfinite(med), med, torch.ones_like(med))

    out = torch.cat(
        [(mean_d / med[:, None, None]).reshape(L, -1), mean_n.reshape(L, -1), frac.reshape(L, -1)], dim=-1
    )
    return out.reshape(lead + out.shape[-1:])


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """``linspace(0, 1, n)`` as the reference computes it: ``i * (1/(n-1))``
    with the last entry exactly 1 (its values decide which points a floor
    selects, so the last bit matters)."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) * _full(1.0 / (n - 1), dtype, device)
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def _histogram(x, w, lo, hi, bins, eps):
    """Normalized weighted histograms of (..., P) values over [lo, hi) in
    ``bins`` bins (out-of-range values fall in the end bins), summed as a
    one-hot product, so the order of additions is fixed."""
    scale = _full(1.0 / (hi - lo), x.dtype, x.device)
    ix = torch.clamp(((x - lo) * scale * bins).to(torch.int32), 0, bins - 1)
    onehot = ix[..., None] == torch.arange(bins, dtype=torch.int32, device=x.device)
    h = (onehot.to(x.dtype) * w[..., None]).sum(-2)
    return h / torch.clamp(h.sum(-1, keepdim=True), min=eps)


def keyframe_descriptors_invariant(
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    n_sample: int = 128,
    bins: int = 16,
) -> torch.Tensor:
    """Viewpoint-robust per-keyframe descriptor from pairwise geometry.

    Built only from quantities invariant under rigid camera motion of the
    visible point set (pairwise point distances, pairwise normal angles,
    normal-versus-chord angles, point-to-centroid distances) as normalized
    histograms: two views of the same region give similar descriptors at
    any relative orientation. Distances are normalized by the
    SEQUENCE-pooled mean pairwise distance of each batch entry, so the
    descriptor is dimensionless while the frames' differences in extent
    stay in it.

    Args:
        points: (..., L, N, 3) CAMERA-frame per-keyframe point sets.
        normals: (..., L, N, 3) camera-frame unit normals.
        valid: (..., L, N) bool.
        n_sample: points subsampled per frame (pairwise cost O(n_sample^2)).
        bins: histogram resolution.

    Returns:
        (..., L, 4*bins) descriptors, each histogram summing to 1.
    """
    return graphed("keyframe_descriptors_invariant", _keyframe_descriptors_invariant, (points, normals, valid),
                   n_sample=n_sample, bins=bins)


def _keyframe_descriptors_invariant(points, normals, valid, n_sample, bins):
    dtype, dev = points.dtype, points.device
    eps = 1e-12
    N = points.shape[-2]

    # a deterministic spread subsample of the valid points: valid entries
    # first (stable), then n_sample evenly spaced picks
    order = torch.argsort(torch.where(valid, 0, 1), dim=-1, stable=True)
    cnt = valid.sum(-1)  # (..., L)
    lin = _linspace01(n_sample, dtype, dev)
    pos = torch.floor(lin * torch.clamp(cnt - 1, min=0).to(dtype)[..., None]).to(torch.int64)
    sel = torch.gather(order, -1, torch.clamp(pos, max=N - 1))
    sv = (torch.arange(n_sample, device=dev) < cnt[..., None]) & (cnt[..., None] > 0)
    take = lambda x: torch.gather(x, -2, sel[..., None].expand(sel.shape + (3,)))
    p_s, n_s = take(points), take(normals)

    eye = torch.eye(n_sample, dtype=torch.bool, device=dev)
    pair_v = sv[..., :, None] & sv[..., None, :] & ~eye
    pshape = pair_v.shape[:-2] + (n_sample * n_sample,)
    wpair = pair_v.to(dtype).reshape(pshape)

    diff = p_s[..., :, None, :] - p_s[..., None, :, :] + eps
    D = torch.sqrt((diff * diff).sum(-1))
    # PFH alpha: |cos| of the angle between a point's normal and the chord
    # to its pair partner (normal orientation conventions differ)
    alpha = torch.abs((diff * n_s[..., :, None, :]).sum(-1)) / torch.clamp(D, min=eps)
    ndot = torch.clamp((n_s[..., :, None, :] * n_s[..., None, :, :]).sum(-1), -1.0, 1.0).reshape(pshape)

    svf = sv.to(dtype)
    c = (p_s * svf[..., None]).sum(-2) / torch.clamp(cnt.to(dtype), min=1.0)[..., None]
    dcv = p_s - c[..., None, :] + eps
    dc = torch.sqrt((dcv * dcv).sum(-1))
    D, alpha = D.reshape(pshape), alpha.reshape(pshape)

    # sequence-pooled distance scales
    scale = (D * wpair).sum((-2, -1)) / torch.clamp(wpair.sum((-2, -1)), min=1.0)
    Dn = D / torch.clamp(scale, min=eps)[..., None, None]
    scale_c = (dc * svf).sum((-2, -1)) / torch.clamp(svf.sum((-2, -1)), min=1.0)
    dcn = dc / torch.clamp(scale_c, min=eps)[..., None, None]

    return torch.cat(
        [
            _histogram(Dn, wpair, 0.0, 3.0, bins, eps),
            _histogram(ndot, wpair, -1.0, 1.0, bins, eps),
            _histogram(alpha, wpair, 0.0, 1.0, bins, eps),
            _histogram(dcn, svf, 0.0, 3.0, bins, eps),
        ],
        dim=-1,
    )


def detect_loop_closures_descriptor(
    descriptors: torch.Tensor,
    max_candidates: int = 8,
    min_separation: int = 5,
    max_descriptor_dist: float = 0.25,
) -> LoopCandidates:
    """Drift-robust detection: keyframe pairs whose (..., L, D) descriptors
    differ by an RMS below ``max_descriptor_dist``, at least
    ``min_separation`` frames apart; the ``max_candidates`` most similar
    pairs are taken.

    Returns:
        LoopCandidates with (..., K, 2) index pairs, i < j.
    """
    return graphed("detect_loop_closures_descriptor", _detect_loop_closures_descriptor, (descriptors,),
                   max_candidates=max_candidates, min_separation=min_separation,
                   max_descriptor_dist=max_descriptor_dist)


def _detect_loop_closures_descriptor(descriptors, max_candidates, min_separation, max_descriptor_dist):
    L = descriptors.shape[-2]
    diff = descriptors[..., :, None, :] - descriptors[..., None, :, :]
    rms = torch.sqrt((diff * diff).mean(-1))  # (..., L, L)
    ok = (_separation(L, descriptors.device) >= min_separation) & (rms < max_descriptor_dist)
    score = torch.where(ok, -rms, torch.full_like(rms, -torch.inf))
    return _top_candidates(score, L, max_candidates)


def _yaw_seeds(yaw_hypotheses, dtype, device) -> torch.Tensor:
    """(H, 4, 4) rotations about the camera's up (y) axis."""
    ang = torch.stack([_full(a, dtype, device) for a in yaw_hypotheses])
    ca, sa = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones_like(ang), torch.zeros_like(ang)
    rows = [ca, zero, sa, zero, zero, one, zero, zero, -sa, zero, ca, zero, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(-1, 4, 4)


def verify_loop_closures(
    candidates: LoopCandidates,
    poses: torch.Tensor,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_valid: torch.Tensor,
    numiters: int = 20,
    dist_thresh: Optional[float] = None,
    inlier_dist: float = 0.05,
    min_inlier_frac: float = 0.5,
    init: str = "poses",
    yaw_hypotheses: Tuple[float, ...] = (0.0, 0.5236, -0.5236, 1.0472, -1.0472, 1.5708, -1.5708),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refines each candidate's relative pose with ICP and scores it.

    Every candidate solves in ONE batched gradICP call: the source is frame
    j's camera-frame points, the target frame i's, so the recovered
    transform is ``Z_ij``. A candidate is accepted when at least
    ``min_inlier_frac`` of its valid source points land within
    ``inlier_dist`` of their nearest target after alignment (one more KNN
    call over the whole batch).

    Args:
        candidates: (K, 2) pairs and (K,) validity.
        poses: (L, 4, 4) current pose estimates.
        frame_points / frame_normals: (L, N, 3) per-keyframe CAMERA-frame
            point and normal sets; frame_valid: (L, N) bool.
        dist_thresh: ICP association gate on the squared distance; with
            ``'multistart'`` it defaults to ``3 * inlier_dist``.
        init: ``'poses'`` seeds ICP with the current relative estimate,
            ``'identity'`` with I, ``'multistart'`` with each of
            ``yaw_hypotheses`` (rotations about the camera's up axis; one
            batched solve of K * H problems) and keeps the hypothesis with
            the best inlier fraction.

    Returns:
        (measurements (K, 4, 4), weights (K,)): relative transforms
        ``Z_ij ~ T_i^-1 T_j`` and acceptance weights (0 for rejected or
        invalid candidates), ready for :class:`PoseGraph` edges.
    """
    if init not in ("poses", "identity", "multistart"):
        raise ValueError(f"init must be 'poses', 'identity' or 'multistart', got {init!r}")
    if init == "multistart" and dist_thresh is None:
        # the candidate views overlap only partially: ungated point-to-plane
        # lets the points outside the overlap drag the solve off
        dist_thresh = 3.0 * inlier_dist
    i = candidates.edges[:, 0].long()
    j = candidates.edges[:, 1].long()
    K = i.shape[0]
    dtype, dev = poses.dtype, poses.device

    if init == "poses":
        Z0 = matmul_small(inverse_transformation(poses[i]), poses[j])  # (K, 4, 4)
        nh = 1
    elif init == "identity":
        Z0 = torch.eye(4, dtype=dtype, device=dev).expand(K, 4, 4)
        nh = 1
    else:
        seeds = _yaw_seeds(yaw_hypotheses, dtype, dev)
        nh = seeds.shape[0]
        Z0 = seeds[None].expand(K, nh, 4, 4).reshape(-1, 4, 4)

    def expand(x):
        """Tiles per-candidate data over the hypothesis axis."""
        if nh == 1:
            return x
        return x[:, None].expand((K, nh) + x.shape[1:]).reshape((K * nh,) + x.shape[1:])

    src = expand(frame_points[j])  # (K*H, N, 3), camera frame of j
    src_valid = expand(frame_valid[j])
    tgt = expand(frame_points[i])
    tgt_n = expand(frame_normals[i])
    tgt_valid = expand(frame_valid[i])

    Z = point_to_plane_gradICP(
        src, tgt, tgt_n, Z0, numiters=numiters, dist_thresh=dist_thresh,
        src_valid=src_valid.to(src.dtype), tgt_valid=tgt_valid,
    )  # (K*H, 4, 4)

    # inlier scoring: nearest-neighbour distances of the aligned sources
    sq_d, _ = knn(transform_pointcloud(src, Z), tgt, tgt_valid)
    inlier = (sq_d < inlier_dist**2) & src_valid & torch.isfinite(sq_d)
    n_valid = torch.clamp(src_valid.sum(-1), min=1)
    frac = inlier.sum(-1).to(dtype) / n_valid.to(dtype)  # (K*H,)

    if nh > 1:
        # keep the best hypothesis of each candidate (the first of equals)
        frac_kh = frac.reshape(K, nh)
        best = torch.argmax(frac_kh, dim=-1)
        ar = torch.arange(K, device=dev)
        Z = Z.reshape(K, nh, 4, 4)[ar, best]
        frac = frac_kh[ar, best]

    accept = (frac >= min_inlier_frac) & candidates.valid
    return Z, accept.to(dtype)


def _check_detection(detection, descriptors):
    if detection not in _DETECTIONS:
        raise ValueError(f"detection must be 'pose', 'appearance' or 'both', got {detection!r}")
    if detection in ("appearance", "both") and descriptors is None:
        raise ValueError(f"detection={detection!r} requires descriptors (keyframe_descriptors output)")


def _candidate_sets(poses, descriptors, detection, max_candidates, min_separation, max_distance, max_angle,
                    max_descriptor_dist, appearance_init):
    """(candidates, ICP seed) per active detector, over (..., L) inputs."""
    sets = []
    if detection in ("pose", "both"):
        sets.append((_detect_loop_closures(poses, max_candidates, min_separation, max_distance, max_angle), "poses"))
    if detection in ("appearance", "both"):
        cand = _detect_loop_closures_descriptor(descriptors, max_candidates, min_separation, max_descriptor_dist)
        sets.append((cand, appearance_init))
    return sets


def _dedup(edges, w_loop, L):
    """Zeroes the weight of an accepted pair that an earlier slot (the other
    detector's) already carries, so a double-detected closure enters the
    pose graph once: (..., K') edges and weights."""
    key = edges[..., 0].long() * L + edges[..., 1].long()
    live = w_loop > 0
    Kp = key.shape[-1]
    ar = torch.arange(Kp, device=key.device)
    tri = ar[:, None] > ar[None, :]
    dup = ((key[..., :, None] == key[..., None, :]) & live[..., :, None] & live[..., None, :] & tri).any(-1)
    return torch.where(dup, torch.zeros_like(w_loop), w_loop)


def _refine_with_loops(poses, edges_loop, Z_loop, w_loop, odometry_weight, loop_weight, refine_iters):
    """The pose graph of (B, L) trajectories: consecutive odometry edges
    measured from the input trajectory plus the loop edges; refined."""
    B, L = poses.shape[:2]
    dev = poses.device
    ar = torch.arange(L - 1, device=dev, dtype=torch.int32)
    edges_odo = torch.stack([ar, ar + 1], dim=-1).expand(B, L - 1, 2)
    Z_odo = relative_transformation(poses[:, :-1], poses[:, 1:], orthogonal_rotations=True)
    graph = PoseGraph(
        poses=poses,
        edges=torch.cat([edges_odo, edges_loop.to(torch.int32)], dim=1),
        measurements=torch.cat([Z_odo, Z_loop], dim=1),
        weights=torch.cat([torch.full((B, L - 1), odometry_weight, dtype=poses.dtype, device=dev),
                           w_loop * loop_weight], dim=1),
    )
    return pose_graph_refine(graph, num_iters=refine_iters)


def close_loops(
    poses: torch.Tensor,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_valid: torch.Tensor,
    max_candidates: int = 8,
    min_separation: int = 5,
    max_distance: float = 0.5,
    max_angle: float = 1.0472,
    icp_numiters: int = 20,
    inlier_dist: float = 0.05,
    min_inlier_frac: float = 0.5,
    refine_iters: int = 10,
    odometry_weight: float = 1.0,
    loop_weight: float = 1.0,
    detection: str = "pose",
    descriptors: Optional[torch.Tensor] = None,
    max_descriptor_dist: float = 0.25,
    appearance_init: str = "multistart",
) -> Tuple[torch.Tensor, LoopCandidates, torch.Tensor]:
    """Detect, verify and correct: the whole loop-closure pipeline.

    Builds a pose graph from consecutive-frame odometry edges (measured
    from the input trajectory) and the ICP-verified loop edges, and runs
    Gauss-Newton. With no accepted loop edge the input trajectory is the
    optimum of the chain graph and comes back (numerically) unchanged. One
    sequence is a batch of one for :func:`close_loops_batched`.

    Args:
        poses: (L, 4, 4) drifted trajectory (one sequence; see
            :func:`close_loops_batched` for a batch).
        frame_points / frame_normals / frame_valid: per-keyframe
            camera-frame point sets, (L, N, 3) / (L, N, 3) / (L, N).
        detection: ``'pose'`` (proximity of the current estimates),
            ``'appearance'`` (:func:`detect_loop_closures_descriptor` on
            ``descriptors``) or ``'both'`` (each set verified with its own
            seed; a pair found and accepted by both enters the pose graph
            once).
        descriptors: (L, D) :func:`keyframe_descriptors` or
            :func:`keyframe_descriptors_invariant` output, required for
            ``detection`` in ('appearance', 'both').
        appearance_init: ICP seed of appearance-detected candidates,
            ``'multistart'`` (default) or ``'identity'``.

    Returns:
        (refined_poses (L, 4, 4), candidates, loop_weights (K,)), K being
        ``max_candidates`` per active detector.
    """
    _check_detection(detection, descriptors)
    refined, cand, w_loop = close_loops_batched(
        poses[None], frame_points[None], frame_normals[None], frame_valid[None],
        max_candidates=max_candidates, min_separation=min_separation, max_distance=max_distance,
        max_angle=max_angle, icp_numiters=icp_numiters, inlier_dist=inlier_dist, min_inlier_frac=min_inlier_frac,
        refine_iters=refine_iters, odometry_weight=odometry_weight, loop_weight=loop_weight, detection=detection,
        descriptors=None if descriptors is None else descriptors[None], max_descriptor_dist=max_descriptor_dist,
        appearance_init=appearance_init,
    )
    return refined[0], LoopCandidates(edges=cand.edges[0], valid=cand.valid[0]), w_loop[0]


def close_loops_batched(
    poses: torch.Tensor,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_valid: torch.Tensor,
    max_candidates: int = 8,
    min_separation: int = 5,
    max_distance: float = 0.5,
    max_angle: float = 1.0472,
    icp_numiters: int = 20,
    inlier_dist: float = 0.05,
    min_inlier_frac: float = 0.5,
    refine_iters: int = 10,
    odometry_weight: float = 1.0,
    loop_weight: float = 1.0,
    detection: str = "pose",
    descriptors: Optional[torch.Tensor] = None,
    max_descriptor_dist: float = 0.25,
    appearance_init: str = "multistart",
) -> Tuple[torch.Tensor, LoopCandidates, torch.Tensor]:
    """:func:`close_loops` over (B, L, ...) inputs, one batched operation per
    stage: detection over the batch, ICP verification as ONE solve over all
    B*K candidates of a detector (the per-keyframe clouds flatten to a
    (B*L, N, 3) axis and candidate pairs get per-entry offsets), and one
    batched (B, 6L, 6L) Gauss-Newton solve per iteration.

    Args / returns: as :func:`close_loops`, with a leading batch axis on
    ``poses`` (B, L, 4, 4), the frame tensors (B, L, N, ...),
    ``descriptors`` (B, L, D) and every output.

    On a CUDA device the whole closure is one captured graph per set of
    static arguments (``slam/stepgraph.graphed``).
    """
    _check_detection(detection, descriptors)
    return graphed(
        "close_loops_batched", _close_loops_batched, (poses, frame_points, frame_normals, frame_valid, descriptors),
        max_candidates=max_candidates, min_separation=min_separation, max_distance=max_distance, max_angle=max_angle,
        icp_numiters=icp_numiters, inlier_dist=inlier_dist, min_inlier_frac=min_inlier_frac,
        refine_iters=refine_iters, odometry_weight=odometry_weight, loop_weight=loop_weight, detection=detection,
        max_descriptor_dist=max_descriptor_dist, appearance_init=appearance_init,
    )


def _close_loops_batched(poses, frame_points, frame_normals, frame_valid, descriptors, max_candidates,
                         min_separation, max_distance, max_angle, icp_numiters, inlier_dist, min_inlier_frac,
                         refine_iters, odometry_weight, loop_weight, detection, max_descriptor_dist,
                         appearance_init):
    B, L = poses.shape[:2]
    N = frame_points.shape[2]
    sets = _candidate_sets(poses, descriptors, detection, max_candidates, min_separation, max_distance, max_angle,
                           max_descriptor_dist, appearance_init)
    poses_flat = poses.reshape(B * L, 4, 4)
    pts_flat = frame_points.reshape(B * L, N, 3)
    nrm_flat = frame_normals.reshape(B * L, N, 3)
    val_flat = frame_valid.reshape(B * L, N)
    offs = (torch.arange(B, dtype=torch.int32, device=poses.device) * L)[:, None, None]

    Z_parts, w_parts = [], []
    for cand, init in sets:
        K = cand.edges.shape[1]
        flat = LoopCandidates(edges=(cand.edges + offs).reshape(B * K, 2), valid=cand.valid.reshape(B * K))
        Z_f, w_f = verify_loop_closures(
            flat, poses_flat, pts_flat, nrm_flat, val_flat, numiters=icp_numiters,
            inlier_dist=inlier_dist, min_inlier_frac=min_inlier_frac, init=init,
        )
        Z_parts.append(Z_f.reshape(B, K, 4, 4))
        w_parts.append(w_f.reshape(B, K))
    cand = LoopCandidates(edges=torch.cat([c.edges for c, _ in sets], dim=1),
                          valid=torch.cat([c.valid for c, _ in sets], dim=1))
    Z_loop, w_loop = torch.cat(Z_parts, dim=1), torch.cat(w_parts, dim=1)
    if len(sets) > 1:
        w_loop = _dedup(cand.edges, w_loop, L)
    refined = _refine_with_loops(poses, cand.edges, Z_loop, w_loop, odometry_weight, loop_weight, refine_iters)
    return refined, cand, w_loop


def frame_clouds_from_rgbd(depth_seq: torch.Tensor, intrinsics: torch.Tensor, dsratio: int = 4):
    """Per-keyframe camera-frame clouds of a (B, L, H, W, 1) depth sequence.

    Returns (pts (B, L, S, 3), nrm (B, L, S, 3), val (B, L, S), normal_map
    (B, L, H, W, 3), valid (B, L, H, W, 1)): the strided vertex and normal
    map subsamples that detection and verification use, and the
    full-resolution maps for grid descriptors.
    """
    from ..structures.rgbdimages import compute_normal_map, compute_vertex_map, valid_depth_mask

    B, L = depth_seq.shape[:2]
    vm = compute_vertex_map(depth_seq, intrinsics)
    valid = valid_depth_mask(depth_seq)
    nm = compute_normal_map(vm, valid)
    sl = (slice(None), slice(None), slice(None, None, dsratio), slice(None, None, dsratio))
    pts = vm[sl].reshape(B, L, -1, 3)
    nrm = nm[sl].reshape(B, L, -1, 3)
    val = valid[sl].reshape(B, L, -1)
    return pts, nrm, val, nm, valid


def close_loops_rgbd(
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    poses: torch.Tensor,
    dsratio: int = 4,
    descriptor: str = "invariant",
    **kwargs,
) -> torch.Tensor:
    """Loop-closes a SLAM trajectory directly from its RGB-D inputs:

        map_state, poses = slam_sequence(rgb, depth, K, None, opts, cap)
        poses = close_loops_rgbd(rgb, depth, K, poses)

    Args:
        rgb_seq: (B, L, H, W, 3); depth_seq: (B, L, H, W, 1).
        intrinsics: (B, 1, 4, 4); poses: (B, L, 4, 4) recovered trajectory.
        dsratio: vertex-map subsampling stride of the per-keyframe clouds.
        descriptor: for appearance detection, ``'invariant'``
            (:func:`keyframe_descriptors_invariant`, default) or ``'grid'``
            (:func:`keyframe_descriptors`, same-viewpoint revisits only).
        **kwargs: forwarded to :func:`close_loops_batched`.

    Returns:
        (B, L, 4, 4) refined trajectory. On a CUDA device the clouds, the
        descriptors and the closure are one captured graph per set of
        static arguments (``slam/stepgraph.graphed``; ``rgb_seq`` is not
        read).
    """
    if descriptor not in ("invariant", "grid"):
        raise ValueError(f"descriptor must be 'invariant' or 'grid', got {descriptor!r}")
    return graphed("close_loops_rgbd", _close_loops_rgbd, (depth_seq, intrinsics, poses), dsratio=dsratio,
                   descriptor=descriptor, **kwargs)


def _close_loops_rgbd(depth_seq, intrinsics, poses, dsratio, descriptor, **kwargs):
    pts, nrm, val, nm, valid = frame_clouds_from_rgbd(depth_seq, intrinsics, dsratio)
    descs = None
    if kwargs.get("detection", "pose") in ("appearance", "both"):
        if descriptor == "invariant":
            descs = keyframe_descriptors_invariant(pts, nrm, val)
        else:
            descs = keyframe_descriptors(depth_seq[..., 0], nm, valid[..., 0])
    refined, _, _ = close_loops_batched(poses, pts, nrm, val, **({} if descs is None else {"descriptors": descs}),
                                        **kwargs)
    return refined
