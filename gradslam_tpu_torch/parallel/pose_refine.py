"""Pose refinement on one device: pose-graph Gauss-Newton and
Schur-complement bundle adjustment (PyTorch port of the single-device part
of gradslam_tpu.parallel.pose_refine).

  - :func:`pose_graph_refine`: Gauss-Newton over SE(3) keyframe poses with
    relative-pose (odometry / loop-closure) edges. The Jacobians are
    forward-mode derivatives of the edge residual with respect to left
    perturbations (``torch.func.jvp``), so nothing is derived by hand,
    and the whole loop is differentiable with ``backward()``. Graphs with a
    leading batch axis solve together: one (B, 6L, 6L) solve per iteration.
  - :func:`ba_refine`: point-landmark bundle adjustment with the 3x3
    landmark blocks eliminated by a Schur complement, solving only the
    reduced 6L x 6L camera system, either materialized (``'dense'``) or
    matrix-free by preconditioned conjugate gradients (``'pcg'``, with an
    implicit gradient: its backward is one more PCG solve).

Every sum of per-edge or per-observation rows into pose, pose-pair or
landmark bins is a segmented scan over the rows sorted by bin
(:func:`_segment_sum`): exact float32 products and a fixed order of
additions, so a run on the card repeats itself bit for bit (a float atomic
adds in no fixed order, and a float32 matmul may run in TF32).

The sharded refiners split the rows over the ranks of a mesh axis: each rank
linearizes its edges (:func:`pose_graph_refine_sharded`) or the observations
of the landmarks it owns (:func:`ba_refine_sharded`), the per-rank normal
equations are summed with ``all_reduce``, and every rank solves the small
reduced system.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..geometry import inverse_transformation, se3_exp, se3_log
from ..geometry.projutils import matmul_small, matvec
from ..utils.profiling import spanned

__all__ = [
    "PoseGraph",
    "pose_graph_residuals",
    "pose_graph_refine",
    "pose_graph_refine_sharded",
    "ba_refine",
    "ba_refine_sharded",
    "partition_observations_by_landmark",
]


class PoseGraph(NamedTuple):
    """A pose graph: L keyframe poses and E relative-pose constraints.

    Attributes:
        poses: (L, 4, 4) world-from-keyframe transforms, or (B, L, 4, 4).
        edges: (E, 2) int (i, j) index pairs, or (B, E, 2).
        measurements: (E, 4, 4) measured relative transforms
            ``Z_ij ~ T_i^-1 T_j``, or (B, E, 4, 4).
        weights: (E,) per-edge information weights (0 disables an edge), or
            (B, E).
    """

    poses: torch.Tensor
    edges: torch.Tensor
    measurements: torch.Tensor
    weights: torch.Tensor


# ---------------------------------------------------------------------------
# deterministic segment sums
# ---------------------------------------------------------------------------


class _Segments(NamedTuple):
    """Rows sorted by bin: ``order`` (N,) sorts the rows, ``boundary`` (N,)
    marks each segment's first sorted row, ``last`` (K,) is the sorted
    index of each bin's last row (N for an empty bin)."""

    order: Optional[torch.Tensor]
    boundary: torch.Tensor
    last: torch.Tensor


def _segments_sorted(keys: torch.Tensor, num_keys: int) -> _Segments:
    """Segments of keys that are already sorted (no permutation)."""
    N = keys.shape[0]
    dev = keys.device
    first = torch.ones(min(N, 1), dtype=torch.bool, device=dev)
    boundary = torch.cat([first, keys[1:] != keys[:-1]])
    is_last = torch.cat([boundary[1:], first])
    # one write per bin (its last row); the rest go to a dropped bin
    dst = torch.where(is_last, keys.long(), num_keys)
    last = torch.full((num_keys + 1,), N, dtype=torch.long, device=dev)
    last = last.scatter(0, dst, torch.arange(N, device=dev))[:num_keys]
    return _Segments(None, boundary, last)


def _segments(keys: torch.Tensor, num_keys: int) -> _Segments:
    """Sorts ``keys`` (N,) in [0, num_keys) stably and finds the segments."""
    sorted_keys, order = torch.sort(keys.long(), stable=True)
    return _segments_sorted(sorted_keys, num_keys)._replace(order=order)


def _landmark_sum_sorted(vals: torch.Tensor, boundary: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Per-bin sum of rows SORTED by bin: (N, ...) -> (K, ...).

    A segmented Hillis-Steele inclusive scan (the running value resets at
    each segment's first row, so a sum never leaves its segment and a
    difference of prefix sums never cancels) and one gather at each bin's
    last row.
    """
    N = vals.shape[0]
    K = last.shape[0]
    flat = vals.reshape(N, -1)
    if N == 0:
        return flat.new_zeros((K,) + vals.shape[1:])
    scan, f = flat, boundary
    d = 1
    while d < N:
        vs = torch.cat([flat.new_zeros((d, flat.shape[1])), scan[:-d]])
        fs = torch.cat([torch.ones(d, dtype=torch.bool, device=f.device), f[:-d]])
        scan = scan + torch.where(f[:, None], torch.zeros_like(vs), vs)
        f = f | fs
        d *= 2
    out = scan[torch.clamp(last, max=N - 1)]
    out = torch.where((last < N)[:, None], out, torch.zeros_like(out))
    return out.reshape((K,) + vals.shape[1:])


def _segment_sum(vals: torch.Tensor, segs: _Segments) -> torch.Tensor:
    """Sums rows (N, ...) into their bins (K, ...) in a fixed order."""
    if segs.order is not None:
        vals = vals[segs.order]
    return _landmark_sum_sorted(vals, segs.boundary, segs.last)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def _edge_residual(T_i, T_j, Z_ij):
    """se3 log of the relative-pose discrepancy (..., 6)."""
    pred = matmul_small(inverse_transformation(T_i), T_j)
    return se3_log(matmul_small(inverse_transformation(Z_ij), pred))


def _gather_poses(poses, idx):
    """poses (B, L, 4, 4), idx (B, E) -> (B, E, 4, 4)."""
    B = poses.shape[0]
    return poses[torch.arange(B, device=poses.device)[:, None], idx.long()]


def _batched(graph: PoseGraph):
    single = graph.poses.dim() == 3
    if not single:
        return graph, False
    return PoseGraph(*(x[None] for x in graph)), True


def pose_graph_residuals(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) stacked edge residuals ((B, E, 6) for a batch of graphs)."""
    g, single = _batched(graph)
    r = _edge_residual(
        _gather_poses(g.poses, g.edges[..., 0]), _gather_poses(g.poses, g.edges[..., 1]), g.measurements
    )
    return r[0] if single else r


def _forward_jacobians(f, rows: int, dims, like):
    """Forward-mode Jacobians of a row-wise function at zero perturbations.

    ``f(*xis)`` maps perturbations (rows, d_k) to (rows, R) residuals, row
    n depending on row n of each ``xi`` only. One forward-mode product per
    perturbation coordinate, all taken in one ``vmap`` over the coordinates
    (the rows stay a tensor axis inside it: a per-row ``vmap`` would hand
    the Lie-group code 0-d tensors, whose forward-mode products with
    Python scalars come out in float64). Returns one (rows, R, d_k) Jacobian
    per perturbation; gradients flow through them with ``backward()``.
    """
    D = sum(dims)
    zeros = tuple(like.new_zeros((rows, d)) for d in dims)
    basis = torch.eye(D, dtype=like.dtype, device=like.device)[:, None, :].expand(D, rows, D)

    def push(v):
        return jvp(f, zeros, tuple(torch.split(v, list(dims), dim=-1)))[1]

    J = vmap(push)(basis).permute(1, 2, 0)  # (rows, R, D)
    return torch.split(J, list(dims), dim=-1)


def _residual_of_perturbation(xi_i, xi_j, Ti, Tj, Z):
    return _edge_residual(matmul_small(se3_exp(xi_i), Ti), matmul_small(se3_exp(xi_j), Tj), Z)


def _linearize_edges(poses, edges, measurements, weights):
    """Per-edge residuals and Jacobians with respect to left perturbations
    of (B, L, 4, 4) poses: (r (B, E, 6), J_i (B, E, 6, 6), J_j (B, E, 6, 6)),
    each scaled by sqrt(weight) so the normal equations see the weight."""
    B, E = edges.shape[:2]
    Ti = _gather_poses(poses, edges[..., 0]).reshape(B * E, 4, 4)
    Tj = _gather_poses(poses, edges[..., 1]).reshape(B * E, 4, 4)
    Z = measurements.reshape(B * E, 4, 4)
    zeros = poses.new_zeros((B * E, 6))
    r = _residual_of_perturbation(zeros, zeros, Ti, Tj, Z)
    J_i, J_j = _forward_jacobians(lambda a, b: _residual_of_perturbation(a, b, Ti, Tj, Z), B * E, (6, 6), poses)
    sw = torch.sqrt(weights).reshape(B * E)
    return (
        (r * sw[:, None]).reshape(B, E, 6),
        (J_i * sw[:, None, None]).reshape(B, E, 6, 6),
        (J_j * sw[:, None, None]).reshape(B, E, 6, 6),
    )


def _gram(A, C):
    """``A^T C`` over the second-to-last axis: (..., a, b), (..., a, c) ->
    (..., b, c), as a multiply-and-sum."""
    return (A[..., :, :, None] * C[..., :, None, :]).sum(-3)


def _graph_segments(L: int, edges: torch.Tensor):
    """Loop-invariant bins of the normal equations: the 4E Hessian blocks
    ``(i,i), (j,j), (i,j), (j,i)`` of each edge into B*L*L blocks, the 2E
    gradient rows into B*L."""
    B = edges.shape[0]
    off = torch.arange(B, device=edges.device)[:, None]
    i, j = edges[..., 0].long(), edges[..., 1].long()
    hkeys = torch.cat([i * L + i, j * L + j, i * L + j, j * L + i], dim=1) + off * (L * L)
    bkeys = torch.cat([i, j], dim=1) + off * L
    return _segments(hkeys.reshape(-1), B * L * L), _segments(bkeys.reshape(-1), B * L)


def _assemble_normal_equations(L, segs, r, J_i, J_j):
    """Sums per-edge blocks into H (B, L, 6, L, 6) and b (B, L, 6)."""
    B = r.shape[0]
    JiTJj = _gram(J_i, J_j)
    blocks = torch.cat([_gram(J_i, J_i), _gram(J_j, J_j), JiTJj, JiTJj.transpose(-1, -2)], dim=1)
    grads = torch.cat([(J_i * r[..., :, None]).sum(-2), (J_j * r[..., :, None]).sum(-2)], dim=1)
    H = _segment_sum(blocks.reshape(-1, 36), segs[0]).reshape(B, L, L, 6, 6).permute(0, 1, 3, 2, 4)
    b = _segment_sum(grads.reshape(-1, 6), segs[1]).reshape(B, L, 6)
    return H, b


@contextlib.contextmanager
def _cusolver(A):
    """The route of a solve on the card: cuSOLVER and cuBLAS, never MAGMA.

    By default ``torch.linalg`` factors a batch of large matrices (the
    (B, 6L, 6L) pose graphs of a batch of trajectories) with MAGMA, which
    cannot be captured in a CUDA graph. The same route runs eagerly and
    captured, so the two give the same bits. No effect on the CPU."""
    if not A.is_cuda:
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class _Solve(torch.autograd.Function):
    """``A^-1 b`` without the singularity check (which waits on the host),
    forward and backward (``A^-T g``) on :func:`_cusolver`'s route."""

    @staticmethod
    def forward(ctx, A, b):
        with _cusolver(A):
            x = torch.linalg.solve_ex(A, b, check_errors=False)[0]
        ctx.save_for_backward(A, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        with _cusolver(A):
            gb = torch.linalg.solve_ex(A.mT, g, check_errors=False)[0]
        return -gb @ x.mT if ctx.needs_input_grad[0] else None, gb


_solve = _Solve.apply


def _inv(A):
    with _cusolver(A):
        return torch.linalg.inv_ex(A, check_errors=False)[0]


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(..., L, 6, 6) diagonal blocks -> (..., L, 6, L, 6) with exact zeros
    elsewhere."""
    L = blocks.shape[-3]
    eye = torch.eye(L, dtype=blocks.dtype, device=blocks.device)
    return eye[:, None, :, None] * blocks[..., :, :, None, :]


def _anchor_blocks(L, like, anchor_weight):
    """(L, 6, 6): ``anchor_weight * I`` on pose 0 only (the gauge prior)."""
    a = like.new_zeros((L, 1, 1))
    a[0] = 1.0
    return a * (anchor_weight * torch.eye(6, dtype=like.dtype, device=like.device))


def _solve_and_update(poses, H, b, damping, anchor_weight):
    B, L = poses.shape[:2]
    H = H + _block_diag(_anchor_blocks(L, poses, anchor_weight))
    Hm = H.reshape(B, L * 6, L * 6) + torch.eye(L * 6, dtype=poses.dtype, device=poses.device) * damping
    delta = _solve(Hm, -b.reshape(B, L * 6, 1))[..., 0].reshape(B, L, 6)
    return matmul_small(se3_exp(delta), poses)


def _pose_graph_iterations(g: PoseGraph, poses, num_iters, damping, anchor_weight, reduce=None):
    L = poses.shape[1]
    segs = _graph_segments(L, g.edges)
    for _ in range(num_iters):
        r, J_i, J_j = _linearize_edges(poses, g.edges, g.measurements, g.weights)
        H, b = _assemble_normal_equations(L, segs, r, J_i, J_j)
        if reduce is not None:
            H, b = reduce(H), reduce(b)
        poses = _solve_and_update(poses, H, b, damping, anchor_weight)
    return poses


def pose_graph_refine(
    graph: PoseGraph,
    num_iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> torch.Tensor:
    """Gauss-Newton pose-graph optimization on one device.

    Returns refined (L, 4, 4) poses, pose 0 gauge-anchored; a graph with a
    leading batch axis (poses (B, L, 4, 4), edges (B, E, 2), ...) gives
    (B, L, 4, 4), every graph solved in the same batched solve. On a CUDA
    device the iterations are one captured graph per (shapes, dtype,
    ``num_iters``, ``damping``, ``anchor_weight``): the JAX package's
    ``jax.jit`` of its ``fori_loop`` (``slam/stepgraph.graphed``).
    """
    from ..slam.stepgraph import graphed

    return graphed("pose_graph_refine", _pose_graph_refine, tuple(graph), num_iters=num_iters, damping=damping,
                   anchor_weight=anchor_weight)


@spanned("loop_closure.pose_graph")
def _pose_graph_refine(poses, edges, measurements, weights, num_iters, damping, anchor_weight):
    g, single = _batched(PoseGraph(poses, edges, measurements, weights))
    poses = _pose_graph_iterations(g, g.poses, num_iters, damping, anchor_weight)
    return poses[0] if single else poses


def _axis_sum(mesh, axis: str, *inputs):
    """The ``reduce`` of a sharded refiner: a sum over the mesh axis.

    The sums carry no gradient across the ranks, so an input that needs one
    raises: :func:`pose_graph_refine` and :func:`ba_refine` differentiate
    on one device."""
    if torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in inputs):
        raise ValueError("the sharded refiners carry no gradient across ranks: differentiate pose_graph_refine "
                         "or ba_refine on one device")
    return lambda x: mesh.all_reduce(x.clone(), axis)


def pose_graph_refine_sharded(
    graph: PoseGraph,
    mesh,
    axis: str = "data",
    num_iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> torch.Tensor:
    """Pose-graph refinement with the edges split over the mesh ``axis``.

    Every rank of the axis passes the same graph. The edges are padded to a
    multiple of the axis size (identity measurements, weight 0) and rank k
    takes the k-th contiguous part: it linearizes its edges and assembles
    their normal equations, ``all_reduce`` sums H (L, 6, L, 6) and b (L, 6)
    over the axis, and every rank solves the same system. Returns the
    refined poses, the same on every rank (batched graphs as in
    :func:`pose_graph_refine`). No gradient crosses the ranks: an input
    that needs one raises.
    """
    g, single = _batched(graph)
    n = mesh.shape[axis]
    E = g.edges.shape[1]
    pad = (-E) % n
    if pad:
        B = g.edges.shape[0]
        eye = torch.eye(4, dtype=g.measurements.dtype, device=g.measurements.device).expand(B, pad, 4, 4)
        g = PoseGraph(
            g.poses,
            torch.cat([g.edges, g.edges.new_zeros((B, pad, 2))], dim=1),
            torch.cat([g.measurements, eye], dim=1),
            torch.cat([g.weights, g.weights.new_zeros((B, pad))], dim=1),
        )
    part = (E + pad) // n
    k = mesh.index(axis)
    mine = PoseGraph(g.poses, *(x[:, k * part : (k + 1) * part] for x in g[1:]))
    poses = _pose_graph_iterations(mine, g.poses, num_iters, damping, anchor_weight, _axis_sum(mesh, axis, *graph))
    return poses[0] if single else poses


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment
# ---------------------------------------------------------------------------


def _ba_linearize(poses, landmarks, obs_pose, obs_lm, obs_pts, weights):
    """Per-observation residuals ``r = T_p^-1 X_l - obs`` and Jacobians:
    (r (N, 3), Jp (N, 3, 6), Jl (N, 3, 3)), each scaled by sqrt(weight)."""
    T_p = poses[obs_pose]
    X_l = landmarks[obs_lm]

    def obs_residual(xi, dX, T, X, z):
        tinv = inverse_transformation(matmul_small(se3_exp(xi), T))
        return matvec(tinv[..., :3, :3], X + dX) + tinv[..., :3, 3] - z

    N = obs_pts.shape[0]
    r = obs_residual(poses.new_zeros((N, 6)), poses.new_zeros((N, 3)), T_p, X_l, obs_pts)
    Jp, Jl = _forward_jacobians(lambda xi, dX: obs_residual(xi, dX, T_p, X_l, obs_pts), N, (6, 3), poses)
    sw = torch.sqrt(weights)
    return r * sw[:, None], Jp * sw[:, None, None], Jl * sw[:, None, None]


def _landmark_segments(obs_lm, M):
    """Loop-invariant segments of observations SORTED by landmark:
    ``(boundary (N,) bool, last_of_lm (M,))``, N for a landmark with no
    observation."""
    segs = _segments_sorted(obs_lm, M)
    return segs.boundary, segs.last


class _BAPrep(NamedTuple):
    """Loop-invariant structure of a BA problem (observations sorted by
    landmark): the landmark segments, the pose bins, and for each pair
    offset d of the dense coupling the partner's pose, the pair's validity
    and the pose-pair bins."""

    lm: _Segments
    pose: _Segments
    pairs: List[Tuple[torch.Tensor, torch.Tensor, _Segments]]


def _pair_offsets(obs_pose, obs_lm, L, k):
    """For d in [0, k): pair (n, n+d) of the landmark-sorted observations,
    matched by rolling the arrays; pairs that wrap past the end or leave
    their landmark are invalid."""
    N = obs_pose.shape[0]
    idx = torch.arange(N, device=obs_pose.device)
    out = []
    for d in range(k):
        pose_s = torch.roll(obs_pose, -d, 0)
        valid = (idx + d < N) & (obs_lm == torch.roll(obs_lm, -d, 0))
        out.append((pose_s, valid, _segments(obs_pose.long() * L + pose_s.long(), L * L)))
    return out


def _schur_coupling(L, prep: _BAPrep, V, W_obs):
    """Pose-pose Schur coupling ``sum_l U_l Hll^-1 U_l^T`` as (L, 6, L, 6).

    Pair (n, n+d) within a landmark's segment contributes ``V_n W_{n+d}^T``
    at block (pose_n, pose_{n+d}) and its transpose at the mirrored block;
    each offset's blocks are summed into pose-pair bins.
    """

    def accumulate(A, segs):
        return _segment_sum(A.reshape(-1, 36), segs).reshape(L, L, 6, 6).permute(0, 2, 1, 3)

    S = None
    for d, (_, valid, segs) in enumerate(prep.pairs):
        W_s = torch.roll(W_obs, -d, 0)
        A = (V[:, :, None, :] * W_s[:, None, :, :]).sum(-1)  # V_n W_s^T (N, 6, 6)
        if d == 0:
            S = accumulate(A, segs)
            continue
        C = accumulate(A * valid.to(A.dtype)[:, None, None], segs)
        S = S + C + C.permute(2, 3, 0, 1)
    return S


def _coupling_matvec(x, obs_pose, obs_lm, W_obs, Hll_inv, prep: _BAPrep):
    """``(U Hll^-1 U^T) x`` without the (L, 6, L, 6) coupling: gather x by
    pose, sum per landmark, 3x3 block products, sum back per pose."""
    t = (W_obs * x[obs_pose][:, :, None]).sum(-2)  # (N, 3)
    s = _segment_sum(t, prep.lm)
    y = matvec(Hll_inv, s)  # (M, 3)
    c = matvec(W_obs, y[obs_lm])  # (N, 6)
    return _segment_sum(c, prep.pose)


def _pcg_iterations(matvec_fn, rhs, Minv_blocks, iters):
    """Preconditioned conjugate gradients on (L, 6) block vectors with a
    block-Jacobi preconditioner ``Minv_blocks`` (L, 6, 6) and a fixed count
    of iterations; alpha and beta are zero-guarded, so iterations past
    convergence change nothing."""

    def dot(a, b):
        return (a * b).sum()

    x = torch.zeros_like(rhs)
    r = rhs
    z = matvec(Minv_blocks, r)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        Ap = matvec_fn(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp)), torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = matvec(Minv_blocks, r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)), torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x


class _PCGSolve(torch.autograd.Function):
    """``y = PCG(r)``: forward and backward are both a PCG solve against the
    same symmetric operator (the backward's cotangent solve)."""

    @staticmethod
    def forward(ctx, r, solve):
        ctx.solve = solve
        return solve(r)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return ctx.solve(g), None


def _pcg_solve(matvec_fn, rhs, Minv_blocks, iters):
    """PCG with the implicit gradient of a linear solve.

    Differentiating through converged CG iterations divides by vanishing
    search directions. The operator is symmetric positive definite, so the
    solve is differentiated implicitly: ``x* = PCG(b)`` without a graph,
    then ``x* + (S(r) - S(r))`` with ``r = b - A x*`` and ``S`` a PCG solve
    whose backward is one more PCG solve. The value is ``x*``; the gradient
    is ``dx = A^-1 (db - dA x*)``, with respect to ``b`` and to every tensor
    the operator closes over.
    """
    Minv = Minv_blocks.detach()

    def solve(b):
        with torch.no_grad():
            return _pcg_iterations(matvec_fn, b, Minv, iters)

    x = solve(rhs.detach())
    if not torch.is_grad_enabled():
        return x
    r = rhs - matvec_fn(x)
    if not r.requires_grad:
        return x
    y = _PCGSolve.apply(r, solve)
    return x + (y - y.detach())


def _ba_iteration(poses, landmarks, obs_pose, obs_lm, obs_pts, weights, prep: _BAPrep, damping,
                  anchor_weight, solver="dense", cg_iters=64, reduce=None):
    """One Schur-complement Gauss-Newton iteration (observations sorted by
    landmark). ``'dense'`` materializes the reduced camera system and
    solves it; ``'pcg'`` applies it matrix-free inside preconditioned CG
    (block-Jacobi on its 6x6 pose diagonal).

    ``reduce`` (None on one device) sums a rank's partial terms over the
    ranks when the observations are split by landmark ownership: the
    camera blocks, the coupling and the right-hand side (dense), the
    preconditioner's blocks, the right-hand side and each CG step's partial
    product ('pcg'), and the landmark updates. A rank's own sums keep
    their fixed order.
    """
    red = reduce or (lambda x: x)
    L = poses.shape[0]
    M = landmarks.shape[0]
    N = obs_pose.shape[0]
    dtype, dev = poses.dtype, poses.device

    r, Jp, Jl = _ba_linearize(poses, landmarks, obs_pose, obs_lm, obs_pts, weights)

    # landmark-indexed sums in one pass: [Jl^T Jl (9) | Jl^T r (3)]
    lm_vals = torch.cat([_gram(Jl, Jl).reshape(N, 9), (Jl * r[:, :, None]).sum(-2)], dim=-1)
    lm_sums = _segment_sum(lm_vals, prep.lm)
    Hll = lm_sums[:, 0:9].reshape(M, 3, 3)
    bl = lm_sums[:, 9:12]

    W_obs = _gram(Jp, Jl)  # (N, 6, 3)
    Hll = Hll + torch.eye(3, dtype=dtype, device=dev) * damping
    Hll_inv = _inv(Hll)
    V = matmul_small(W_obs, Hll_inv[obs_lm])  # (N, 6, 3)

    # pose-indexed sums in one pass: [Jp^T Jp (36) | Jp^T r (6) | V bl[lm] (6)]
    pose_vals = torch.cat(
        [_gram(Jp, Jp).reshape(N, 36), (Jp * r[:, :, None]).sum(-2), matvec(V, bl[obs_lm])], dim=-1
    )
    pose_sums = _segment_sum(pose_vals, prep.pose)
    Hcc = pose_sums[:, 0:36].reshape(L, 6, 6)
    bc = pose_sums[:, 36:42]
    coup = pose_sums[:, 42:48]

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    anchor = _anchor_blocks(L, poses, anchor_weight)
    rhs = red(bc) - red(coup)

    if solver == "dense":
        S = red(_schur_coupling(L, prep, V, W_obs))
        Sm = (-S + _block_diag(red(Hcc) + anchor)).reshape(L * 6, L * 6)
        Sm = Sm + torch.eye(L * 6, dtype=dtype, device=dev) * damping
        delta_c = _solve(Sm, -rhs.reshape(L * 6, 1))[:, 0].reshape(L, 6)
    else:
        # the pose diagonal of the reduced system, each observation's
        # difference taken before the sum (Hcc and the self-coupling are
        # large sums whose difference is damping-small)
        VWt = (V[:, :, None, :] * W_obs[:, None, :, :]).sum(-1)
        diag_S = red(_segment_sum((_gram(Jp, Jp) - VWt).reshape(N, 36), prep.pose).reshape(L, 6, 6))
        Minv = _inv(diag_S + anchor + damping * eye6)

        def matvec_fn(x):
            part = red(matvec(Hcc, x) - _coupling_matvec(x, obs_pose, obs_lm, W_obs, Hll_inv, prep))
            return part + matvec(anchor, x) + damping * x

        delta_c = _pcg_solve(matvec_fn, -rhs, Minv, cg_iters)

    # back-substitute the landmarks: delta_l = -Hll^-1 (bl + W^T delta_c)
    Wt_dc = _segment_sum((W_obs * delta_c[obs_pose][:, :, None]).sum(-2), prep.lm)
    delta_l = red(-matvec(Hll_inv, bl + Wt_dc))
    return matmul_small(se3_exp(delta_c), poses), landmarks + delta_l


def _obs_per_landmark_max(obs_lm) -> int:
    counts = np.bincount(obs_lm.detach().cpu().numpy().astype(np.int64))
    return int(counts.max()) if counts.size else 0


def _validate_k_max(obs_lm, max_obs_per_landmark, solver, true_max=None):
    """Rejects a dense-path pair bound below the true count of observations
    of one landmark: the coupling would drop pairs and the Gauss-Newton step
    would be wrong with no error. ``'pcg'`` has no pair expansion."""
    if solver != "dense" or max_obs_per_landmark is None:
        return
    true_max = _obs_per_landmark_max(obs_lm) if true_max is None else true_max
    if true_max > max_obs_per_landmark:
        raise ValueError(
            f"max_obs_per_landmark={max_obs_per_landmark} but a landmark has {true_max} observations: "
            f"the dense Schur coupling would silently drop pairs and produce a wrong Gauss-Newton step. "
            f"Pass max_obs_per_landmark>={true_max} or solver='pcg' (no pair bound)."
        )


def _ba_refine_impl(poses, landmarks, obs_pose, obs_lm, obs_pts, weights, num_iters, damping, anchor_weight,
                    k_max, solver, cg_iters, true_max):
    L, M = poses.shape[0], landmarks.shape[0]
    N = obs_pts.shape[0]
    if weights is None:
        weights = poses.new_ones(N)
    order = torch.argsort(obs_lm, stable=True)
    obs_pose, obs_lm = obs_pose[order].long(), obs_lm[order].long()
    obs_pts, weights = obs_pts[order], weights[order]
    # pairs at an offset past a landmark's observation count are never
    # valid, so the loop stops at the count as well as at the bound
    k = min(k_max, N, true_max) if solver == "dense" else 0
    prep = _BAPrep(
        lm=_segments_sorted(obs_lm, M),
        pose=_segments(obs_pose, L),
        pairs=_pair_offsets(obs_pose, obs_lm, L, max(k, 1)) if solver == "dense" else [],
    )
    for _ in range(num_iters):
        poses, landmarks = _ba_iteration(poses, landmarks, obs_pose, obs_lm, obs_pts, weights, prep, damping,
                                         anchor_weight, solver=solver, cg_iters=cg_iters)
    return poses, landmarks


def ba_refine(
    poses: torch.Tensor,
    landmarks: torch.Tensor,
    obs_pose: torch.Tensor,
    obs_lm: torch.Tensor,
    obs_pts: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    num_iters: int = 5,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    max_obs_per_landmark: Optional[int] = None,
    solver: str = "dense",
    cg_iters: int = 64,
):
    """Point-landmark bundle adjustment with Schur-complement elimination.

    The 3x3 block-diagonal landmark block is eliminated analytically and
    only the reduced camera system is solved: materialized
    (``solver='dense'``, O(L^2) memory, an exact solve; for L up to a few
    hundred) or matrix-free (``solver='pcg'``, block-Jacobi preconditioned
    CG, O(N + L + M) memory). The dense coupling is summed from observation
    pairs within each landmark's segment (observations are sorted by
    landmark internally).

    Args:
        poses: (L, 4, 4); landmarks: (M, 3).
        obs_pose / obs_lm: (N,) int indices; obs_pts: (N, 3) camera-frame
            observations.
        weights: optional (N,) observation weights.
        max_obs_per_landmark: bound on the observations of one landmark
            (default L), dense solver only; a bound below the true count
            raises.
        solver: 'dense' or 'pcg'.
        cg_iters: CG iterations per Gauss-Newton step (pcg only).

    Returns:
        (refined_poses (L, 4, 4), refined_landmarks (M, 3)). On a CUDA
        device the iterations are one captured graph per (shapes, dtypes,
        ``num_iters``, ``damping``, ``anchor_weight``, the pair bound,
        ``solver``, ``cg_iters``, the true count of observations of one
        landmark), as the JAX package jits ``_ba_refine_impl``.
    """
    if solver not in ("dense", "pcg"):
        raise ValueError(f"solver must be 'dense' or 'pcg', got {solver!r}")
    from ..slam.stepgraph import graphed

    # the host reads the observation counts outside the graph, as the JAX
    # package's _validate_k_max does outside its jit; the count is static
    true_max = _obs_per_landmark_max(obs_lm) if solver == "dense" else 0
    _validate_k_max(obs_lm, max_obs_per_landmark, solver, true_max)
    k_max = poses.shape[0] if max_obs_per_landmark is None else max_obs_per_landmark
    return graphed("ba_refine", _ba_refine_impl, (poses, landmarks, obs_pose, obs_lm, obs_pts, weights),
                   num_iters=num_iters, damping=damping, anchor_weight=anchor_weight, k_max=k_max, solver=solver,
                   cg_iters=cg_iters, true_max=true_max)


def partition_observations_by_landmark(obs_pose, obs_lm, obs_pts, weights, n):
    """Host-side prep for :func:`ba_refine_sharded` (a copy of the JAX
    package's, numpy in and out).

    Sorts observations by landmark and splits them into ``n`` shards at
    landmark boundaries (every landmark's observations land on exactly one
    shard: landmark ownership), padding shards to equal length with
    weight-0 observations.

    Returns (obs_pose (n, Ns), obs_lm (n, Ns), obs_pts (n, Ns, 3),
    weights (n, Ns), max_obs_per_landmark).
    """
    obs_pose = np.asarray(obs_pose)
    obs_lm = np.asarray(obs_lm)
    obs_pts = np.asarray(obs_pts)
    weights = np.asarray(weights)
    N = obs_lm.shape[0]

    order = np.argsort(obs_lm, kind="stable")
    obs_pose, obs_lm, obs_pts, weights = obs_pose[order], obs_lm[order], obs_pts[order], weights[order]
    uniq, starts, counts = np.unique(obs_lm, return_index=True, return_counts=True)
    k_max = int(counts.max()) if counts.size else 1
    # segment s goes to the shard its cumulative midpoint falls in
    cum = np.cumsum(counts) - counts / 2.0
    shard_of_seg = np.minimum((cum * n / max(N, 1)).astype(int), n - 1)

    per_shard = [[] for _ in range(n)]
    for s, st, c in zip(shard_of_seg, starts, counts):
        per_shard[s].append((st, c))
    Ns = max(max((sum(c for _, c in segs) for segs in per_shard), default=1), 1)

    out_pose = np.zeros((n, Ns), obs_pose.dtype)
    out_lm = np.zeros((n, Ns), obs_lm.dtype)
    out_pts = np.zeros((n, Ns, 3), obs_pts.dtype)
    out_w = np.zeros((n, Ns), weights.dtype)
    for s, segs in enumerate(per_shard):
        o = 0
        for st, c in segs:
            sl = slice(st, st + c)
            out_pose[s, o : o + c] = obs_pose[sl]
            out_lm[s, o : o + c] = obs_lm[sl]
            out_pts[s, o : o + c] = obs_pts[sl]
            out_w[s, o : o + c] = weights[sl]
            o += c
        # Padding rows carry the shard's LAST owned landmark id (not 0):
        # each shard's observation list must stay SORTED by landmark for
        # the segmented-scan reductions. A trailing run of landmark 0 would
        # form a segment of its own whose (zero) sums overwrite landmark
        # 0's real sums on its owner shard; with the last owned id the
        # zero-weight pads join the final real segment and add nothing.
        if o and o < Ns:
            out_lm[s, o:] = out_lm[s, o - 1]
    return out_pose, out_lm, out_pts, out_w, k_max


def ba_refine_sharded(
    poses: torch.Tensor,
    landmarks: torch.Tensor,
    obs_pose: torch.Tensor,
    obs_lm: torch.Tensor,
    obs_pts: torch.Tensor,
    mesh,
    axis: str = "data",
    weights: Optional[torch.Tensor] = None,
    num_iters: int = 5,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    solver: str = "dense",
    cg_iters: int = 64,
):
    """Schur-complement bundle adjustment with the observations split over
    the mesh ``axis`` by landmark ownership
    (:func:`partition_observations_by_landmark`).

    Every rank of the axis passes the same problem and keeps the shard of
    its index. A landmark's observations all sit on one rank, so its 3x3
    block, its coupling pairs and its back-substitution are complete
    there. With ``solver='dense'`` an iteration sums, over the axis, the
    (L, 6, 6) camera blocks, the (L, 6, L, 6) coupling and the (L, 6)
    right-hand side terms, plus the (M, 3) landmark updates; with
    ``'pcg'`` the coupling is never formed and each CG step sums one
    (L, 6) partial product. The pair bound of the dense coupling is the
    partition's true maximum, so no pair is dropped. No gradient crosses the
    ranks: an input that needs one raises (:func:`ba_refine` differentiates).

    Returns (refined_poses (L, 4, 4), refined_landmarks (M, 3)), the same
    on every rank.
    """
    if solver not in ("dense", "pcg"):
        raise ValueError(f"solver must be 'dense' or 'pcg', got {solver!r}")
    n = mesh.shape[axis]
    N = obs_pts.shape[0]
    if weights is None:
        weights = poses.new_ones(N)
    reduce = _axis_sum(mesh, axis, poses, landmarks, obs_pts, weights)
    host = lambda x: x.detach().cpu().numpy()
    s_pose, s_lm, s_pts, s_w, k_max = partition_observations_by_landmark(
        host(obs_pose), host(obs_lm), host(obs_pts), host(weights), n
    )
    k = mesh.index(axis)
    dev = poses.device
    obs_pose, obs_lm = (torch.from_numpy(x[k]).to(dev).long() for x in (s_pose, s_lm))
    obs_pts, weights = (torch.from_numpy(x[k]).to(dev) for x in (s_pts, s_w))
    L, M = poses.shape[0], landmarks.shape[0]
    prep = _BAPrep(
        lm=_segments_sorted(obs_lm, M),
        pose=_segments(obs_pose, L),
        pairs=_pair_offsets(obs_pose, obs_lm, L, max(min(k_max, obs_pose.shape[0]), 1)) if solver == "dense" else [],
    )
    for _ in range(num_iters):
        poses, landmarks = _ba_iteration(poses, landmarks, obs_pose, obs_lm, obs_pts, weights, prep, damping,
                                         anchor_weight, solver=solver, cg_iters=cg_iters, reduce=reduce)
    return poses, landmarks
