"""Loop closure in the port's entry points against the JAX package's
(mirrors TestBatchedCloseLoops and TestRGBDWrapper of
tests/slam/test_loopclosure.py, TestManagedLoopClosure of
tests/slam/test_lifecycle.py and the ``close_loops_rgbd`` step of
tests/integration/test_real_format_e2e.py).

``close_loops_batched`` is held to a loop of ``close_loops`` and to JAX's
batched call (poses within 1e-5, weights equal). ``ICPSLAM`` /
``PointFusion(loop_closure=...)`` in every mode is held to
``close_loops_rgbd`` of its own unclosed poses, bit for bit, and that call to
JAX's on the same poses within 1e-5. ``slam_sequence_managed(loop_closure=...)``
is held to JAX's managed run with closure on the same clip (poses within
2e-4, the lifecycle tests' tolerance) and to its own unclosed run within
0.02 m, the JAX test's bound.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.slam as J
import tests.integration.test_real_format_e2e as E2E
import tests.slam.test_loopclosure as JT
from gradslam_tpu.slam import loopclosure as JL
from gradslam_tpu_torch import ICPSLAM, PointFusion, RGBDImages
from gradslam_tpu_torch.slam import (
    SLAMOptions,
    close_loops,
    close_loops_batched,
    close_loops_rgbd,
    keyframe_descriptors_invariant,
    slam_sequence,
    slam_sequence_managed,
)

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
L = 10
# the rendered TUM tree of the files-to-ATE chain (pytest finds fixtures
# among the module's names)
rendered, tum_tree = E2E.rendered, E2E.tum_tree
TOL = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _terr(a, b):
    return float(np.linalg.norm(np.asarray(a)[..., :3, 3] - np.asarray(b)[..., :3, 3], axis=-1).max())


def _sequence(ds=2, n=L):
    """The golden clip cycled to ``n`` frames at every ``ds``-th pixel."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    idx = [i % colors.shape[1] for i in range(n)]
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= ds
    return (np.ascontiguousarray(colors[:, idx, ::ds, ::ds]), np.ascontiguousarray(depths[:, idx, ::ds, ::ds]), K)


class TestBatchedCloseLoops:
    """close_loops_batched == a loop of close_loops, and == JAX's."""

    @staticmethod
    def _batch(seeds=(0, 7)):
        items = [JT._make_loop(seed=s, drift=0.03) for s in seeds]
        arrays = [np.stack([np.asarray(it[i]) for it in items]) for i in range(5)]
        return arrays, _t(*arrays)

    def test_matches_per_item_close_loops_pose_detection(self):
        (_, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = self._batch()
        kw = dict(max_candidates=4, min_separation=5, max_distance=0.3, icp_numiters=15, refine_iters=8)
        ref = torch.stack([close_loops(tdr[b], tpts[b], tnrm[b], tval[b], **kw)[0] for b in range(2)])
        got, cand, w = close_loops_batched(tdr, tpts, tnrm, tval, **kw)
        assert got.shape == ref.shape and w.shape[0] == 2
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        jgot, jcand, jw = J.close_loops_batched(*(jnp.asarray(a) for a in (dr, pts, nrm, val)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=TOL)
        np.testing.assert_array_equal(cand.edges.numpy(), np.asarray(jcand.edges))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))

    def test_matches_per_item_both_detection(self):
        (_, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = self._batch()
        descs = keyframe_descriptors_invariant(tpts, tnrm, tval)
        kw = dict(max_candidates=3, min_separation=5, max_distance=0.3, icp_numiters=12, refine_iters=6,
                  detection="both", appearance_init="identity")
        ref = torch.stack([close_loops(tdr[b], tpts[b], tnrm[b], tval[b], descriptors=descs[b], **kw)[0]
                           for b in range(2)])
        got, cand, w = close_loops_batched(tdr, tpts, tnrm, tval, descriptors=descs, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        jdescs = jnp.stack([J.keyframe_descriptors_invariant(*(jnp.asarray(a[b]) for a in (pts, nrm, val)))
                            for b in range(2)])
        np.testing.assert_allclose(descs.numpy(), np.asarray(jdescs), atol=TOL)
        jgot, jcand, jw = J.close_loops_batched(*(jnp.asarray(a) for a in (dr, pts, nrm, val)), descriptors=jdescs,
                                                **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=TOL)
        np.testing.assert_array_equal(cand.edges.numpy(), np.asarray(jcand.edges))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))

    def test_validation(self):
        _, (_, tdr, tpts, tnrm, tval) = self._batch()
        with pytest.raises(ValueError, match="detection"):
            close_loops_batched(tdr, tpts, tnrm, tval, detection="nope")
        with pytest.raises(ValueError, match="descriptors"):
            close_loops_batched(tdr, tpts, tnrm, tval, detection="appearance")


class TestRGBDWrapper:
    def test_close_loops_rgbd_runs_on_slam_output(self):
        """Golden clip -> slam_sequence -> close_loops_rgbd, against JAX's
        close_loops_rgbd on the same poses."""
        colors, depths, K = _sequence(ds=1, n=3)
        opts = SLAMOptions(odom="gradicp", numiters=8, fusion=True)
        B, n, H, W = colors.shape[:4]
        rgb, dep, Kt = _t(colors, depths, K)
        _, poses = slam_sequence(rgb, dep, Kt, None, opts, n * H * W)
        kw = dict(min_separation=2, max_distance=0.5, max_candidates=2)
        refined = close_loops_rgbd(rgb, dep, Kt, poses, **kw)
        assert refined.shape == poses.shape
        assert _terr(refined, poses) < 0.02
        assert bool(torch.isfinite(refined).all())
        ref = JL.close_loops_rgbd(*(jnp.asarray(a) for a in (colors, depths, K, poses.numpy())), **kw)
        np.testing.assert_allclose(refined.numpy(), np.asarray(ref), atol=TOL)


class TestEntryPoints:
    @pytest.mark.parametrize("mode", ["pose", "appearance", "both"])
    def test_icpslam_closes_its_own_trajectory(self, mode):
        """``ICPSLAM(loop_closure=mode)`` returns ``close_loops_rgbd`` of
        the unclosed run's poses, which match JAX's on the same poses."""
        colors, depths, K = _sequence(ds=2, n=6)
        kw = dict(min_separation=2, max_candidates=2, max_distance=0.5)
        rgbd = RGBDImages(*_t(colors, depths, K), device="cpu")
        _, plain = ICPSLAM(odom="gradicp", numiters=6, device="cpu")(rgbd)
        _, closed = ICPSLAM(odom="gradicp", numiters=6, loop_closure=mode, loop_closure_kwargs=kw, device="cpu")(rgbd)
        rgbd_cl = rgbd.to_channels_last()
        direct = close_loops_rgbd(rgbd_cl.rgb_image, rgbd_cl.depth_image, rgbd_cl.intrinsics, plain, detection=mode,
                                  **kw)
        assert torch.equal(closed, direct)
        ref = JL.close_loops_rgbd(*(jnp.asarray(a) for a in (colors, depths, K, plain.numpy())), detection=mode, **kw)
        np.testing.assert_allclose(closed.numpy(), np.asarray(ref), atol=TOL)
        assert _terr(closed, plain) < 0.02


class TestManagedLoopClosure:
    """Loop closure inside the managed run, at its segment boundaries."""

    def test_golden_clip_runs_and_stays_consistent(self):
        """The clip cycles its 3 frames, so every revisit is genuine: the
        closure runs at every boundary and stays within 0.02 m of the
        unclosed run, and within 2e-4 of JAX's managed run with closure."""
        colors, depths, K = _sequence(ds=2)
        B, _, H, W, _ = colors.shape
        opts = SLAMOptions(odom="gradicp", numiters=8, fusion=True)
        cap = L * H * W
        lc = dict(loop_closure="both", loop_closure_kwargs=dict(min_separation=2, max_candidates=2, max_distance=0.5))
        rgb, dep, Kt = _t(colors, depths, K)
        _, plain_p = slam_sequence_managed(rgb, dep, Kt, None, opts, cap, segment_len=3)
        man_m, man_p = slam_sequence_managed(rgb, dep, Kt, None, opts, cap, segment_len=3, **lc)
        assert man_p.shape == (B, L, 4, 4)
        assert bool(torch.isfinite(man_p).all()) and bool(torch.isfinite(man_m.data).all())
        assert _terr(man_p, plain_p) < 0.02
        jopts = J.SLAMOptions(odom="gradicp", numiters=8, fusion=True)
        _, ref_p = J.slam_sequence_managed(*(jnp.asarray(a) for a in (colors, depths, K)), None, jopts, cap,
                                           segment_len=3, **lc)
        np.testing.assert_allclose(man_p.numpy(), np.asarray(ref_p), atol=2e-4)

    def test_icpslam_class_loop_closure_option(self):
        colors, depths, K = _sequence(ds=2, n=6)
        rgbd = RGBDImages(*_t(colors, depths, K), device="cpu")
        _, p0 = PointFusion(odom="gradicp", numiters=8, device="cpu")(rgbd)
        _, p1 = PointFusion(odom="gradicp", numiters=8, loop_closure="both",
                            loop_closure_kwargs=dict(min_separation=2, max_candidates=2), device="cpu")(rgbd)
        assert p1.shape == p0.shape
        assert _terr(p1, p0) < 0.02

    def test_icpslam_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="loop_closure"):
            PointFusion(loop_closure="everything", device="cpu")
        colors, depths, K = _sequence(ds=4, n=3)
        with pytest.raises(ValueError, match="loop_closure"):
            slam_sequence_managed(*_t(colors, depths, K), None, SLAMOptions(fusion=True), 1000,
                                  loop_closure="everything")


def test_files_to_ate_with_loop_closure(tum_tree):
    """TUM tree on disk -> DataLoader -> managed SLAM -> close_loops_rgbd ->
    ATE below 5e-3 m (the JAX chain's step and bound), the closure within
    1e-5 of JAX's on the same poses."""
    from gradslam_tpu_torch.datasets import TUM, DataLoader
    from gradslam_tpu_torch.metrics import ate_rmse

    opts = SLAMOptions(odom="gradicp", numiters=12, dsratio=2, fusion=True)
    ds = TUM(str(tum_tree), seqlen=6, height=E2E.H, width=E2E.W)
    colors, depths, K, gt, *_ = next(iter(DataLoader(ds, batch_size=2, num_workers=2, to_device="cpu")))
    B, n = colors.shape[:2]
    _, poses = slam_sequence_managed(colors, depths, K, None, opts, n * E2E.H * E2E.W, segment_len=4)
    kw = dict(dsratio=2, min_separation=3, max_candidates=2)
    closed = close_loops_rgbd(colors, depths, K, poses, **kw)
    ate = ate_rmse(closed, gt)
    assert float(ate.max()) < 5e-3, ate
    ref = JL.close_loops_rgbd(*(jnp.asarray(x.numpy()) for x in (colors, depths, K, poses)), **kw)
    np.testing.assert_allclose(closed.numpy(), np.asarray(ref), atol=TOL)
