"""The port's loop closure against the JAX package's (mirrors
tests/slam/test_loopclosure.py: detection, verification, correction,
appearance and viewpoint-robust detection).

Each JAX test's synthetic loop is made by that module's own seeded
generators and goes through ``gradslam_tpu.slam`` and
``gradslam_tpu_torch.slam``; every JAX assertion is made on the port's
result, and the two packages are held together: candidate pairs, their
validity and the acceptance weights equal, ICP measurements and refined
poses within 1e-5 (float32), descriptors within 1e-5. Candidates with
equal scores come in ascending index order in both packages (``lax.top_k``
and the port's stable descending sort), which the invalid slots, present
in the ICP batch and the pose graph with weight 0, rely on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.slam as J
import tests.slam.test_loopclosure as JT
from gradslam_tpu_torch.slam import (
    LoopCandidates,
    close_loops,
    detect_loop_closures,
    detect_loop_closures_descriptor,
    keyframe_descriptors,
    keyframe_descriptors_invariant,
    verify_loop_closures,
)
from gradslam_tpu_torch.slam import loopclosure as TL

torch.set_num_threads(2)

TOL = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _pose_err(a, b):
    return float(np.linalg.norm(np.asarray(a)[..., :3, 3] - np.asarray(b)[..., :3, 3], axis=-1).max())


def _same_candidates(jc, tc):
    np.testing.assert_array_equal(tc.edges.numpy(), np.asarray(jc.edges))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


def _same_closure(ref, got):
    """(refined, candidates, weights) of both packages."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=TOL)
    _same_candidates(ref[1], got[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def _loop():
    tp, dr, pts, nrm, val = JT._make_loop()
    return (tp, dr, pts, nrm, val), _t(tp, dr, pts, nrm, val)


class TestTopK:
    def test_ties_come_in_ascending_index_order(self):
        """The scores of the module docstring's example: the stable sort
        gives ``lax.top_k``'s order where ``torch.topk`` does not."""
        score = np.array([-np.inf, 0.5, -np.inf, 1.0, 0.5, -np.inf], np.float32)
        import jax

        _, ref = jax.lax.top_k(jnp.asarray(score), 5)
        _, got = TL._top_k(torch.from_numpy(score), 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), [3, 1, 4, 0, 2])

    def test_all_invalid_detection_matches(self):
        """No pair passes: every slot is invalid, and its pair is the same
        as JAX's (the first flat indices, in order)."""
        L = 8
        poses = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        poses[:, 0, 3] = np.arange(L)
        ref = J.detect_loop_closures(jnp.asarray(poses), max_candidates=6, min_separation=3, max_distance=0.5)
        got = detect_loop_closures(*_t(poses), max_candidates=6, min_separation=3, max_distance=0.5)
        _same_candidates(ref, got)
        assert not bool(got.valid.any())

    def test_equal_distances_keep_jax_order(self):
        """A trajectory revisiting two places at identical distances: equal
        scores among valid candidates."""
        L = 10
        poses = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        poses[:, 0, 3] = [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
        ref = J.detect_loop_closures(jnp.asarray(poses), max_candidates=12, min_separation=3, max_distance=1.5)
        got = detect_loop_closures(*_t(poses), max_candidates=12, min_separation=3, max_distance=1.5)
        _same_candidates(ref, got)
        assert int(got.valid.sum()) == 12


class TestDetect:
    def test_finds_the_loop_pair(self):
        (tp, dr, *_), (_, tdr, *_) = _loop()
        ref = J.detect_loop_closures(dr, max_candidates=4, min_separation=5, max_distance=0.3)
        cand = detect_loop_closures(tdr, max_candidates=4, min_separation=5, max_distance=0.3)
        got = cand.edges.numpy()[cand.valid.numpy()]
        assert len(got) >= 1
        assert any((i == 0 and j == 8) for i, j in got)
        _same_candidates(ref, cand)

    def test_min_separation_excludes_neighbors(self):
        (_, dr, *_), (_, tdr, *_) = _loop()
        ref = J.detect_loop_closures(dr, max_candidates=8, min_separation=5, max_distance=10.0)
        cand = detect_loop_closures(tdr, max_candidates=8, min_separation=5, max_distance=10.0)
        got = cand.edges.numpy()[cand.valid.numpy()]
        assert (got[:, 1] - got[:, 0] >= 5).all()
        _same_candidates(ref, cand)

    def test_no_candidates_on_straight_line(self):
        L = 8
        poses = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        poses[:, 0, 3] = np.arange(L)
        cand = detect_loop_closures(*_t(poses), max_candidates=4, min_separation=3, max_distance=0.5)
        assert not bool(cand.valid.any())
        _same_candidates(J.detect_loop_closures(jnp.asarray(poses), max_candidates=4, min_separation=3,
                                                max_distance=0.5), cand)


class TestVerifyAndClose:
    @pytest.mark.parametrize("init", ["poses", "identity", "multistart"])
    def test_verification_recovers_relative_pose(self, init):
        """Each seed's measurements and weights against JAX's; the accepted
        measurements match the true relative poses."""
        (tp, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = _loop()
        jc = J.detect_loop_closures(dr, max_candidates=4, min_separation=5, max_distance=0.3)
        cand = LoopCandidates(*_t(jc.edges, jc.valid))
        Zr, wr = J.verify_loop_closures(jc, dr, pts, nrm, val, init=init)
        Z, w = verify_loop_closures(cand, tdr, tpts, tnrm, tval, init=init)
        np.testing.assert_array_equal(w.numpy(), np.asarray(wr))
        np.testing.assert_allclose(Z.numpy(), np.asarray(Zr), atol=TOL)
        accepted = w.numpy() > 0
        assert accepted.any()
        for k in np.nonzero(accepted)[0]:
            i, j = cand.edges[k].tolist()
            Z_true = np.linalg.inv(np.asarray(tp[i])) @ np.asarray(tp[j])
            np.testing.assert_allclose(Z[k].numpy(), Z_true, atol=5e-3)

    def test_close_loops_reduces_drift(self):
        (tp, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = _loop()
        kw = dict(max_candidates=4, min_separation=5, max_distance=0.3)
        got = close_loops(tdr, tpts, tnrm, tval, **kw)
        assert bool((got[2] > 0).any()), "no loop edges accepted"
        assert _pose_err(got[0], tp) < 0.5 * _pose_err(dr, tp)
        _same_closure(J.close_loops(dr, pts, nrm, val, **kw), got)

    def test_no_loops_is_a_near_noop(self):
        L, n = 8, 128
        rng = np.random.RandomState(1)
        world = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        world[:, 2] += 4
        poses, pts, nrm = [], [], []
        for k in range(L):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.1 * k
            poses.append(T)
            Tinv = np.linalg.inv(T)
            pts.append(world @ Tinv[:3, :3].T + Tinv[:3, 3])
            nrm.append(np.tile([0, 0, 1.0], (n, 1)).astype(np.float32))
        arrays = (np.stack(poses), np.stack(pts), np.stack(nrm), np.ones((L, n), bool))
        kw = dict(max_candidates=4, min_separation=3, max_distance=0.2)
        got = close_loops(*_t(*arrays), **kw)
        assert not bool((got[2] > 0).any())
        assert _pose_err(got[0], arrays[0]) < 1e-4
        _same_closure(J.close_loops(*(jnp.asarray(a) for a in arrays), **kw), got)


class TestAppearanceDetection:
    """Drift so large that pose-proximity detection fails; the
    pose-independent descriptor still finds the revisit."""

    @staticmethod
    def _data():
        arrays = JT.TestAppearanceDetection._make_drifted_loop()
        return arrays, _t(*arrays)

    @staticmethod
    def _descriptors(depth_imgs):
        """Both packages' grid descriptors of the same depth images (normal
        maps from the JAX test's own construction)."""
        ref = JT.TestAppearanceDetection()._descriptors(depth_imgs)
        from gradslam_tpu.structures.rgbdimages import compute_normal_map, compute_vertex_map

        L, H, W = depth_imgs.shape
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 0.8 * W
        K[0, 2], K[1, 2] = W / 2.0, H / 2.0
        dep5 = depth_imgs[:, None, ..., None]
        nm = compute_normal_map(compute_vertex_map(dep5, jnp.asarray(np.broadcast_to(K, (L, 1, 4, 4)).copy())),
                                dep5 > 0)[:, 0]
        got = keyframe_descriptors(*_t(depth_imgs, nm, np.asarray(depth_imgs) > 0))
        return ref, got

    def test_pose_proximity_fails_under_drift(self):
        (_, dr, *_), (_, tdr, *_) = self._data()
        cand = detect_loop_closures(tdr, max_candidates=4, min_separation=5, max_distance=0.3)
        assert not bool(cand.valid.any())
        _same_candidates(J.detect_loop_closures(dr, max_candidates=4, min_separation=5, max_distance=0.3), cand)

    def test_descriptor_detects_the_revisit(self):
        (*_, depth_imgs), _ = self._data()
        ref, descs = self._descriptors(depth_imgs)
        np.testing.assert_allclose(descs.numpy(), np.asarray(ref), atol=TOL)
        kw = dict(max_candidates=4, min_separation=5, max_descriptor_dist=0.1)
        cand = detect_loop_closures_descriptor(descs, **kw)
        got = cand.edges.numpy()[cand.valid.numpy()]
        assert any((i == 0 and j == 8) for i, j in got), got
        _same_candidates(J.detect_loop_closures_descriptor(ref, **kw), cand)

    def test_close_loops_appearance_fixes_what_pose_cannot(self):
        (tp, dr, pts, nrm, val, depth_imgs), (_, tdr, tpts, tnrm, tval, _) = self._data()
        err_before = _pose_err(dr, tp)
        assert err_before > 0.3
        kw = dict(max_candidates=4, min_separation=5, max_distance=0.3)
        ref_pose, _, w_pose = close_loops(tdr, tpts, tnrm, tval, detection="pose", **kw)
        assert not bool((w_pose > 0).any())
        assert _pose_err(ref_pose, dr) < 1e-4

        ref_desc, descs = self._descriptors(depth_imgs)
        kw.update(detection="appearance", max_descriptor_dist=0.1)
        got = close_loops(tdr, tpts, tnrm, tval, descriptors=descs, **kw)
        assert bool((got[2] > 0).any()), "no appearance loop edges accepted"
        assert _pose_err(got[0], tp) < 0.5 * err_before
        _same_closure(J.close_loops(dr, pts, nrm, val, descriptors=ref_desc, **kw), got)

    def test_option_validation(self):
        _, (tp, tdr, tpts, tnrm, tval, _) = self._data()
        with pytest.raises(ValueError, match="requires descriptors"):
            close_loops(tdr, tpts, tnrm, tval, detection="appearance")
        with pytest.raises(ValueError, match="detection must be"):
            close_loops(tdr, tpts, tnrm, tval, detection="nope")
        with pytest.raises(ValueError, match="init must be"):
            verify_loop_closures(detect_loop_closures(tdr), tdr, tpts, tnrm, tval, init="nope")


class TestViewpointRobustDetection:
    """Revisit at 33 degrees of yaw under large drift: pose proximity and
    the grid descriptor fail; the invariant descriptor and multistart
    verification close the loop."""

    L = JT.TestViewpointRobustDetection.L

    @staticmethod
    def _data():
        arrays = JT.TestViewpointRobustDetection._make_yaw_loop()
        return arrays, _t(*arrays)

    def test_pose_and_grid_both_fail(self):
        (tp, dr, *_), (_, tdr, *_) = self._data()
        cand = detect_loop_closures(tdr, max_candidates=4, min_separation=2, max_distance=0.3)
        assert not bool(cand.valid.any())
        gref = JT.TestViewpointRobustDetection._grid_descriptors()
        kw = dict(max_candidates=4, min_separation=2, max_descriptor_dist=0.25)
        gcand = detect_loop_closures_descriptor(*_t(gref), **kw)
        got = gcand.edges.numpy()[gcand.valid.numpy()]
        assert not any((i == 0 and j == self.L - 1) for i, j in got), got
        _same_candidates(J.detect_loop_closures_descriptor(gref, **kw), gcand)

    def test_invariant_descriptor_finds_the_rotated_revisit(self):
        (tp, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = self._data()
        ref = J.keyframe_descriptors_invariant(pts, nrm, val)
        desc = keyframe_descriptors_invariant(tpts, tnrm, tval)
        np.testing.assert_allclose(desc.numpy(), np.asarray(ref), atol=TOL)
        kw = dict(max_candidates=4, min_separation=2, max_descriptor_dist=0.05)
        cand = detect_loop_closures_descriptor(desc, **kw)
        got = cand.edges.numpy()[cand.valid.numpy()]
        assert any((i == 0 and j == self.L - 1) for i, j in got), got
        _same_candidates(J.detect_loop_closures_descriptor(ref, **kw), cand)

    def test_close_loops_invariant_multistart_cuts_drift(self):
        (tp, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = self._data()
        err_before = _pose_err(dr, tp)
        assert err_before > 0.3
        kw = dict(max_candidates=4, min_separation=2, detection="appearance", max_descriptor_dist=0.05,
                  min_inlier_frac=0.45)
        got = close_loops(tdr, tpts, tnrm, tval, descriptors=keyframe_descriptors_invariant(tpts, tnrm, tval), **kw)
        refined, cand, w = got
        assert bool((w > 0).any()), "no loop edges accepted"
        for k in np.nonzero(w.numpy() > 0)[0]:
            i, j = cand.edges[k].tolist()
            assert i == 0 and j == self.L - 1, (i, j)
        assert _pose_err(refined, tp) < 0.5 * err_before
        _same_closure(J.close_loops(dr, pts, nrm, val, descriptors=J.keyframe_descriptors_invariant(pts, nrm, val),
                                    **kw), got)


class TestInvariantDescriptorParts:
    def test_subsample_positions_match_jax_linspace(self):
        """The spread subsample's positions decide which points a floor
        picks: the port's ``linspace`` is JAX's to the bit."""
        for n in (7, 128, 256):
            np.testing.assert_array_equal(TL._linspace01(n, torch.float32, "cpu").numpy(),
                                          np.asarray(jnp.linspace(0.0, 1.0, n)))

    def test_partial_validity_and_batch_axis(self):
        """Frames with few or no valid points, and a leading batch axis
        (each entry pooled over its own frames) against JAX per entry."""
        rng = np.random.default_rng(3)
        B, L, N = 2, 4, 300
        pts = (rng.normal(size=(B, L, N, 3)) + [0, 0, 3]).astype(np.float32)
        nrm = rng.normal(size=(B, L, N, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        val = rng.random((B, L, N)) < np.array([0.9, 0.3, 0.01, 0.0])[None, :, None]
        got = keyframe_descriptors_invariant(*_t(pts, nrm, val), n_sample=64, bins=8)
        for b in range(B):
            ref = J.keyframe_descriptors_invariant(*(jnp.asarray(x[b]) for x in (pts, nrm, val)), n_sample=64,
                                                   bins=8)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=TOL)

