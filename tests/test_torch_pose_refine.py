"""The port's pose refinement against the JAX package's (mirrors the
single-device classes of tests/parallel/test_pose_refine.py:
TestPoseGraphRefine, TestBA and TestBAPCG).

Every problem is made once from a seeded numpy generator and goes through
``gradslam_tpu.parallel.pose_refine`` and ``gradslam_tpu_torch.parallel``.
Tolerances: refined poses and landmarks within 1e-5 of JAX's in float32
(measured at most ~1e-6), the Jacobians of the edge and observation
residuals within 1e-5 of ``jax.jacfwd``'s, and each JAX test's own
assertion on the port's result. The scaling test runs the port's 'pcg'
solver on one device at the JAX test's size (L=256, M=1e5), which JAX
reaches on a virtual 8-device mesh, and holds it to the same ground-truth
bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.parallel.test_pose_refine as J
from gradslam_tpu.parallel import pose_refine as JP
from gradslam_tpu_torch.geometry import se3_exp
from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine, pose_graph_residuals
from gradslam_tpu_torch.parallel import pose_refine as TP

torch.set_num_threads(2)

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _tgraph(g):
    return PoseGraph(*(_t(x) for x in g))


def _ba_args(*arrays):
    return tuple(_t(x) for x in arrays), tuple(jnp.asarray(x) for x in arrays)


class TestPoseGraphRefine:
    def test_residuals_zero_at_gt(self):
        graph, gt = J.make_graph(np.random.RandomState(0), noise=0.0)
        r = pose_graph_residuals(_tgraph(graph))
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-4)
        np.testing.assert_allclose(r.numpy(), np.asarray(JP.pose_graph_residuals(graph)), atol=TOL)

    def test_recovers_ground_truth(self):
        graph, gt = J.make_graph(np.random.RandomState(1), L=8, noise=0.05)
        tg = _tgraph(graph)
        refined = pose_graph_refine(tg, num_iters=10)
        r_before = pose_graph_residuals(tg).abs().max()
        r_after = pose_graph_residuals(tg._replace(poses=refined)).abs().max()
        assert r_after < 1e-3, f"residual after refine: {r_after}"
        assert r_after < r_before / 10
        np.testing.assert_allclose(refined.numpy(), gt, atol=5e-3)
        ref = np.asarray(JP.pose_graph_refine(graph, num_iters=10))
        np.testing.assert_allclose(refined.numpy(), ref, atol=TOL)

    def test_weight_zero_disables_edge(self):
        graph, gt = J.make_graph(np.random.RandomState(2), L=5, noise=0.03, loop_closures=0)
        tg = _tgraph(graph)
        g2 = PoseGraph(
            poses=tg.poses,
            edges=torch.cat([tg.edges, torch.tensor([[0, 4]], dtype=torch.int32)]),
            measurements=torch.cat([tg.measurements, torch.eye(4)[None]]),
            weights=torch.cat([tg.weights, torch.zeros(1)]),
        )
        a = pose_graph_refine(tg, num_iters=5)
        b = pose_graph_refine(g2, num_iters=5)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(JP.pose_graph_refine(graph, num_iters=5)), atol=TOL)

    def test_batched_graphs_match_each_graph(self):
        """A (B, L) batch of graphs solves as each graph alone (the port's
        batched solve stands in for JAX's vmap)."""
        graphs = [J.make_graph(np.random.RandomState(s), L=6, noise=0.04)[0] for s in (3, 4)]
        E = min(g.edges.shape[0] for g in graphs)
        graphs = [JP.PoseGraph(g.poses, g.edges[:E], g.measurements[:E], g.weights[:E]) for g in graphs]
        batch = PoseGraph(*(torch.stack([_t(g[k]) for g in graphs]) for k in range(4)))
        got = pose_graph_refine(batch, num_iters=6)
        for b, g in enumerate(graphs):
            np.testing.assert_allclose(got[b].numpy(), pose_graph_refine(_tgraph(g), num_iters=6).numpy(), atol=1e-6)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(JP.pose_graph_refine(g, num_iters=6)), atol=TOL)


class TestJacobians:
    """The linearization's Jacobians against ``jax.jacfwd`` on the same
    inputs, with consistent edges (residual at the identity, where
    ``se3_log`` takes its clamped small-angle path) and noisy ones."""

    @pytest.mark.parametrize("noise", [0.0, 0.05])
    def test_edge_jacobians_match_jacfwd(self, noise):
        graph, _ = J.make_graph(np.random.RandomState(5), L=7, noise=noise, loop_closures=3)
        w = np.random.RandomState(6).uniform(0.5, 2.0, graph.weights.shape[0]).astype(np.float32)
        rj, Jij, Jjj = JP._linearize_edges(graph.poses, graph.edges, graph.measurements, jnp.asarray(w))
        rt, Jit, Jjt = TP._linearize_edges(_t(graph.poses)[None], _t(graph.edges)[None],
                                           _t(graph.measurements)[None], _t(w)[None])
        for a, b in ((rj, rt), (Jij, Jit), (Jjj, Jjt)):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a), atol=TOL)

    def test_observation_jacobians_match_jacfwd(self):
        rng = np.random.RandomState(7)
        gt_p, gt_l, ip, il, op, ol, opts = J.make_ba_problem(rng, L=4, M=12, obs_per_lm=3)
        w = rng.uniform(0.5, 2.0, op.shape[0]).astype(np.float32)
        (tp, tl, top, tol, tpts, tw), (jp, jl, jop, jol, jpts, jw) = _ba_args(ip, il, op, ol, opts, w)
        ref = JP._ba_linearize(jp, jl, jop, jol, jpts, jw)
        got = TP._ba_linearize(tp, tl, top.long(), tol.long(), tpts, tw)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)


class TestSegmentSums:
    def test_sorted_scan_matches_index_add(self):
        """The segmented scan sums each bin's rows, empty bins are zero, and
        the unsorted form sums through its permutation."""
        rng = np.random.default_rng(0)
        keys = torch.from_numpy(rng.integers(0, 50, 1000))
        keys[keys == 7] = 8  # bin 7 empty
        vals = torch.from_numpy(rng.normal(size=(1000, 5)))
        ref = torch.zeros(60, 5, dtype=torch.float64).index_add_(0, keys, vals)
        got = TP._segment_sum(vals, TP._segments(keys, 60))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
        assert bool((got[7] == 0).all()) and bool((got[50:] == 0).all())
        srt = torch.sort(keys).values
        got_sorted = TP._landmark_sum_sorted(vals[torch.argsort(keys, stable=True)],
                                             *TP._landmark_segments(srt, 60))
        np.testing.assert_allclose(got_sorted.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


class TestBA:
    def test_recovers_poses_and_landmarks(self):
        rng = np.random.RandomState(4)
        L, M = 4, 30
        gt_poses = [np.eye(4, dtype=np.float32)]
        for _ in range(L - 1):
            xi = rng.randn(6).astype(np.float32) * 0.2
            gt_poses.append(gt_poses[-1] @ se3_exp(torch.from_numpy(xi)).numpy())
        gt_poses = np.stack(gt_poses)
        gt_lms = rng.randn(M, 3).astype(np.float32) * 2.0 + np.array([0, 0, 5], np.float32)
        obs_pose, obs_lm, obs_pts = [], [], []
        for p in range(L):
            tinv = np.linalg.inv(gt_poses[p])
            for l in range(M):
                obs_pose.append(p)
                obs_lm.append(l)
                obs_pts.append(tinv[:3, :3] @ gt_lms[l] + tinv[:3, 3])
        init_poses = gt_poses.copy()
        for i in range(1, L):
            xi = rng.randn(6).astype(np.float32) * 0.05
            init_poses[i] = se3_exp(torch.from_numpy(xi)).numpy() @ init_poses[i]
        init_lms = gt_lms + rng.randn(M, 3).astype(np.float32) * 0.05
        args_t, args_j = _ba_args(init_poses, init_lms, np.asarray(obs_pose, np.int32),
                                  np.asarray(obs_lm, np.int32), np.stack(obs_pts).astype(np.float32))
        poses, lms = ba_refine(*args_t, num_iters=10, damping=1e-6)
        np.testing.assert_allclose(poses.numpy(), gt_poses, atol=1e-2)
        np.testing.assert_allclose(lms.numpy(), gt_lms, atol=1e-2)
        jp, jl = JP.ba_refine(*args_j, num_iters=10, damping=1e-6)
        np.testing.assert_allclose(poses.numpy(), np.asarray(jp), atol=TOL)
        np.testing.assert_allclose(lms.numpy(), np.asarray(jl), atol=TOL)

    def test_reduces_residual(self):
        rng = np.random.RandomState(5)
        L, M = 3, 10
        poses = np.broadcast_to(np.eye(4, dtype=np.float32), (L, 4, 4)).copy()
        lms = rng.randn(M, 3).astype(np.float32) + [0, 0, 4]
        obs_pose = np.repeat(np.arange(L, dtype=np.int32), M)
        obs_lm = np.tile(np.arange(M, dtype=np.int32), L)
        obs = np.concatenate([lms] * L) + rng.randn(L * M, 3).astype(np.float32) * 0.01
        args_t, args_j = _ba_args(poses, (lms + 0.1).astype(np.float32), obs_pose, obs_lm, obs.astype(np.float32))
        p2, l2 = ba_refine(*args_t, num_iters=5)
        err_before = np.abs(lms + 0.1 - obs[:M]).mean()
        err_after = np.abs(l2.numpy() - obs[:M]).mean()
        assert err_after < err_before
        jp, jl = JP.ba_refine(*args_j, num_iters=5)
        np.testing.assert_allclose(p2.numpy(), np.asarray(jp), atol=TOL)
        np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=TOL)


class TestBAPCG:
    def test_pcg_matches_dense(self):
        gt_p, gt_l, ip, il, op, ol, opts = J.make_ba_problem(np.random.RandomState(13), L=6, M=64, obs_per_lm=4)
        args_t, args_j = _ba_args(ip, il, op, ol, opts)
        dense_p, dense_l = ba_refine(*args_t, num_iters=6, damping=1e-6)
        pcg_p, pcg_l = ba_refine(*args_t, num_iters=6, damping=1e-6, solver="pcg", cg_iters=80)
        np.testing.assert_allclose(pcg_p.numpy(), dense_p.numpy(), atol=1e-4)
        np.testing.assert_allclose(pcg_l.numpy(), dense_l.numpy(), atol=1e-4)
        for solver, (p, l) in (("dense", (dense_p, dense_l)), ("pcg", (pcg_p, pcg_l))):
            jp, jl = JP.ba_refine(*args_j, num_iters=6, damping=1e-6, solver=solver, cg_iters=80)
            np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=TOL, err_msg=solver)
            np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=TOL, err_msg=solver)

    def test_dense_bound_validation(self):
        gt_p, gt_l, ip, il, op, ol, opts = J.make_ba_problem(np.random.RandomState(17), L=6, M=16, obs_per_lm=5)
        args_t, _ = _ba_args(ip, il, op, ol, opts)
        with pytest.raises(ValueError, match="silently drop"):
            ba_refine(*args_t, num_iters=1, max_obs_per_landmark=2)
        with pytest.raises(ValueError, match="solver must be"):
            ba_refine(*args_t, num_iters=1, solver="cholesky")
        # pcg has no pair expansion: the same bound is fine
        ba_refine(*args_t, num_iters=1, max_obs_per_landmark=2, solver="pcg")

    def test_pcg_scales_past_dense_ceiling(self):
        """L=256 poses, M=1e5 landmarks, N=3e5 observations on one device,
        converging to the ground truth within the JAX test's bounds."""
        rng = np.random.RandomState(19)
        gt_p, gt_l, ip, il, op, ol, opts = J.make_ba_problem_vec(rng, L=256, M=100_000, obs_per_lm=3, noise=0.02)
        args_t, _ = _ba_args(ip, il, op, ol, opts)
        p, l = ba_refine(*args_t, num_iters=4, damping=1e-6, solver="pcg", cg_iters=48)
        pose_err = np.abs(p.numpy() - gt_p).max()
        assert pose_err < 5e-3, pose_err
        err = np.linalg.norm(l.numpy() - gt_l, axis=1)
        assert np.median(err) < 5e-3, np.median(err)
