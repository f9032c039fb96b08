"""Float64 gradients through the port's refinement stack (mirrors
tests/slam/test_refinement_grad.py): through the pose-graph Gauss-Newton,
bundle adjustment with both solvers, and the whole ``close_loops``.

Each gradient is taken with ``backward()`` in float64 on the CPU and held
to the port's own central differences at the JAX test's coordinates and
``rtol``, and to ``jax.grad`` of the JAX package on the same inputs (rtol
1e-6 of the largest component). As in JAX, the KNN indices, the candidate
selection and the accept threshold are locally constant, so a small
central difference sees the same discrete choices as the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.parallel import pose_refine as JP
from gradslam_tpu.slam import close_loops as j_close_loops
from gradslam_tpu_torch.geometry import se3_exp
from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine
from gradslam_tpu_torch.slam import close_loops

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_compile_caches():
    """Drops JAX's compiled programs before each float64 comparison: toggling
    ``jax.enable_x64`` after many compilations in one process has crashed XLA's CPU compiler
    (tests/slam/test_refinement_grad.py)."""
    jax.clear_caches()
    yield


def _exp(xi):
    return se3_exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()


def _fd_check(loss, x, coords, rtol=5e-4, atol=1e-8, eps=1e-6):
    """The port's gradient of ``loss`` at ``x`` (float64 numpy) against its
    own central differences at ``coords``; returns the gradient."""
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    loss(xt).backward()
    g = xt.grad.numpy()
    for idx in coords:
        d = np.zeros(x.shape)
        d[idx] = eps
        with torch.no_grad():
            fd = (float(loss(torch.tensor(x + d))) - float(loss(torch.tensor(x - d)))) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=rtol, atol=atol, err_msg=f"grad mismatch at {idx}")
    return g


def _same_as_jax(g, jax_loss, x):
    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _chain(rng, L, scale=0.1):
    poses = [np.eye(4)]
    for _ in range(L - 1):
        poses.append(poses[-1] @ _exp(rng.randn(6) * scale))
    return np.stack(poses)


class TestPoseGraphGrad:
    def test_grad_wrt_measurements_float64(self):
        rng = np.random.RandomState(0)
        L = 5
        poses = _chain(rng, L)
        edges = np.asarray([[i, i + 1] for i in range(L - 1)] + [[0, L - 1]], np.int32)
        Z = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in edges])
        weights = np.ones(edges.shape[0])
        tp, te, tw = torch.from_numpy(poses), torch.from_numpy(edges), torch.from_numpy(weights)

        def loss(Zm):
            refined = pose_graph_refine(PoseGraph(tp, te, Zm, tw), num_iters=3, damping=1e-8)
            return (refined[:, :3, 3] ** 2).sum() + (refined[:, :3, :3] * 0.1).sum()

        g = _fd_check(loss, Z, [(0, 0, 3), (1, 1, 3), (2, 0, 0), (4, 2, 3), (3, 1, 1)])

        def jax_loss(Zm):
            g_ = JP.PoseGraph(jnp.asarray(poses), jnp.asarray(edges), Zm, jnp.asarray(weights))
            refined = JP.pose_graph_refine(g_, num_iters=3, damping=1e-8)
            return jnp.sum(refined[:, :3, 3] ** 2) + jnp.sum(refined[:, :3, :3] * 0.1)

        _same_as_jax(g, jax_loss, Z)

    def test_grad_wrt_poses_and_weights(self):
        rng = np.random.RandomState(1)
        L = 4
        poses = _chain(rng, L)
        edges = np.asarray([[0, 1], [1, 2], [2, 3], [0, 3]], np.int32)
        Z = np.stack([np.linalg.inv(poses[i]) @ poses[j] @ _exp(rng.randn(6) * 0.01) for i, j in edges])
        tp, te, tZ = torch.from_numpy(poses), torch.from_numpy(edges), torch.from_numpy(Z)

        def loss(w):
            return (pose_graph_refine(PoseGraph(tp, te, tZ, w), num_iters=3)[:, :3, 3] ** 2).sum()

        w = torch.ones(4, dtype=torch.float64, requires_grad=True)
        loss(w).backward()
        gw = w.grad.numpy()
        assert np.isfinite(gw).all() and np.abs(gw).max() > 0

        def jax_loss(wm):
            g_ = JP.PoseGraph(jnp.asarray(poses), jnp.asarray(edges), jnp.asarray(Z), wm)
            return jnp.sum(JP.pose_graph_refine(g_, num_iters=3)[:, :3, 3] ** 2)

        _same_as_jax(gw, jax_loss, np.ones(4))
        # and to the initial poses, through the odometry linearization
        _fd_check(lambda p: (pose_graph_refine(PoseGraph(p, te, tZ, torch.ones(4, dtype=torch.float64)),
                                               num_iters=3)[:, :3, 3] ** 2).sum(), poses, [(1, 0, 3), (2, 1, 1)])


class TestBAGrad:
    @pytest.mark.parametrize("solver", ["dense", "pcg"])
    def test_grad_wrt_observations_float64(self, solver):
        rng = np.random.RandomState(2)
        L, M = 3, 8
        poses = _chain(rng, L)
        lms = rng.randn(M, 3) * 2 + [0, 0, 5]
        op, ol, opts = [], [], []
        for p in range(L):
            tinv = np.linalg.inv(poses[p])
            for l in range(M):
                op.append(p)
                ol.append(l)
                opts.append(tinv[:3, :3] @ lms[l] + tinv[:3, 3])
        op, ol, obs = np.asarray(op, np.int32), np.asarray(ol, np.int32), np.stack(opts)
        tp, tl, top, tol = (torch.from_numpy(x) for x in (poses, lms, op, ol))

        def loss(o):
            p2, l2 = ba_refine(tp, tl, top, tol, o, num_iters=2, damping=1e-8, solver=solver, cg_iters=40)
            return (p2[:, :3, 3] ** 2).sum() + (l2**2).sum()

        g = _fd_check(loss, obs, [(0, 0), (5, 1), (11, 2), (17, 0)], rtol=1e-3)

        def jax_loss(o):
            p2, l2 = JP.ba_refine(jnp.asarray(poses), jnp.asarray(lms), jnp.asarray(op), jnp.asarray(ol), o,
                                  num_iters=2, damping=1e-8, solver=solver, cg_iters=40)
            return jnp.sum(p2[:, :3, 3] ** 2) + jnp.sum(l2**2)

        _same_as_jax(g, jax_loss, obs)


class TestCloseLoopsGrad:
    def test_grad_wrt_frame_points_float64(self):
        rng = np.random.RandomState(3)
        L, N = 5, 24
        world = rng.uniform(-1, 1, (N, 3))
        world[:, 2] += 4
        normals = rng.randn(N, 3)
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        true_poses, pts, nrms = [], [], []
        for k in range(L):
            ang = 2 * np.pi * k / (L - 1)
            T = np.eye(4)
            T[:3, 3] = 0.1 * np.array([np.cos(ang) - 1.0, np.sin(ang), 0.0])
            true_poses.append(T)
            Ti = np.linalg.inv(T)
            pts.append(world @ Ti[:3, :3].T + Ti[:3, 3])
            nrms.append(normals @ Ti[:3, :3].T)
        drifted = [true_poses[0]]
        for k in range(1, L):
            inc = np.linalg.inv(true_poses[k - 1]) @ true_poses[k]
            drifted.append(drifted[-1] @ (_exp(rng.randn(6) * 0.01) @ inc))
        drifted, pts, nrms = np.stack(drifted), np.stack(pts), np.stack(nrms)
        val = np.ones((L, N), bool)
        kw = dict(max_candidates=2, min_separation=3, max_distance=0.5, icp_numiters=3, refine_iters=2)
        td, tn, tv = (torch.from_numpy(x) for x in (drifted, nrms, val))

        def loss(p):
            return (close_loops(td, p, tn, tv, **kw)[0][:, :3, 3] ** 2).sum()

        _, _, w = close_loops(td, torch.from_numpy(pts), tn, tv, **kw)
        assert bool((w > 0).any())
        g = _fd_check(loss, pts, [(0, 0, 0), (4, 5, 2), (2, 11, 1), (4, 20, 0)], rtol=1e-3, atol=1e-9)

        def jax_loss(p):
            return jnp.sum(j_close_loops(jnp.asarray(drifted), p, jnp.asarray(nrms), jnp.asarray(val), **kw)[0]
                           [:, :3, 3] ** 2)

        _same_as_jax(g, jax_loss, pts)
