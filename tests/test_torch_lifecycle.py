"""The port's arena lifecycle against the JAX package's, and its own
contracts (mirrors tests/slam/test_lifecycle.py, loop closure aside).

Runs past the arena's capacity: the managed run compacts at a watermark,
the compacted run at every segment boundary. Parity with JAX: poses within
2e-4 at 60x80 (measured ~4e-6), ``refresh_slam_state``'s caches equal, a
checkpoint written by JAX resumed by the port within 2e-4 of JAX's own
resume (the gradient through compaction is in
test_torch_lifecycle_grad.py). The voxel size of every parity run is a power of two: XLA's
CPU backend divides by a constant voxel size as a multiply by its float32
reciprocal, which puts a point within one ulp of a cell face in the other
cell (3 cells of 4,900 on this clip at 0.002), while the port divides; by a
power of two the two are the same number. The resume is held bitwise to the
port's own uninterrupted run, with and without ``assoc_window`` (JAX
raises on the latter).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu.slam import lifecycle as JL
from gradslam_tpu.structures.maparena import MapState as JMapState
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.slam import lifecycle as TL
from gradslam_tpu_torch.structures import init_map, voxel_compact_map
from gradslam_tpu_torch.utils import load_slam_state, save_slam_state

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
L = 10
VOXEL_2MM = 2.0**-9  # 1.95 mm
POSE_TOL = 2e-4


def _sequence(ds=1):
    """The golden clip cycled to L frames at every ``ds``-th pixel (numpy)."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    idx = [i % colors.shape[1] for i in range(L)]
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    K[:, :, :2] /= ds
    return (
        np.ascontiguousarray(colors[:, idx, ::ds, ::ds]),
        np.ascontiguousarray(depths[:, idx, ::ds, ::ds]),
        K,
        np.ascontiguousarray(poses[:, idx]),
    )


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _coverage_err(ref_m, got_m):
    """Per-batch worst distance from the reference map's points to the
    nearest point of the tested map."""
    from scipy.spatial import cKDTree

    errs = []
    for b in range(ref_m.data.shape[0]):
        ref = ref_m.points[b][: int(ref_m.num_points[b])].numpy()
        got = got_m.points[b][: int(got_m.num_points[b])].numpy()
        errs.append(cKDTree(got).query(ref)[0].max())
    return max(errs)


def _terr(a, b):
    return float(np.linalg.norm(np.asarray(a)[..., :3, 3] - np.asarray(b)[..., :3, 3], axis=-1).max())


class TestManagedLifecycle:
    def test_aggregate_past_capacity_stays_accurate(self):
        """Aggregate mapping appends every valid pixel: with CAP ~ 2 frames
        the unmanaged arena saturates, the managed one keeps covering the
        surface within the voxel size."""
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        opts = TS.SLAMOptions(odom="gt", fusion=False)
        ref_m, ref_p = TS.slam_sequence(colors, depths, K, poses, opts, L * H * W)
        sat_m, _ = TS.slam_sequence(colors, depths, K, poses, opts, 2 * H * W)
        man_m, man_p = TL.slam_sequence_managed(
            colors, depths, K, poses, opts, 2 * H * W,
            watermark=0.8, segment_len=2, policy="voxel", voxel_size=0.01,
        )
        assert torch.all(sat_m.num_points == 2 * H * W)
        assert torch.all(man_m.num_points < 2 * H * W)
        assert torch.equal(man_p, ref_p)
        err_managed, err_saturated = _coverage_err(ref_m, man_m), _coverage_err(ref_m, sat_m)
        assert err_managed < 0.01, err_managed
        assert err_saturated > 3 * err_managed, (err_saturated, err_managed)

    def test_fusion_gradicp_past_capacity_matches_jax(self):
        """Fused gradICP past capacity: the managed trajectory stays within
        5e-3 of the unlimited run's, and within 2e-4 of JAX's managed run."""
        c, d, K, _ = _sequence(ds=2)
        B, _, H, W, _ = c.shape
        kw = dict(odom="gradicp", numiters=10, fusion=True)
        small = int(1.2 * H * W)
        lkw = dict(watermark=0.85, segment_len=2, policy="voxel", voxel_size=VOXEL_2MM)
        _, ref_p = TS.slam_sequence(*_t(c, d, K), None, TS.SLAMOptions(**kw), L * H * W)
        man_m, man_p = TL.slam_sequence_managed(*_t(c, d, K), None, TS.SLAMOptions(**kw), small, **lkw)
        assert torch.all(man_m.num_points <= small)
        assert _terr(man_p, ref_p) < 5e-3
        jm, jp = JL.slam_sequence_managed(*_j(c, d, K), None, JS.SLAMOptions(**kw), small, **lkw)
        assert _terr(man_p, jp) < POSE_TOL
        assert np.abs(man_p.numpy() - np.asarray(jp)).max() < POSE_TOL
        assert np.array_equal(man_m.num_points.numpy(), np.asarray(jm.num_points))

    def test_evict_policy_drops_low_confidence(self):
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        small = int(1.2 * H * W)
        man_m, _ = TL.slam_sequence_managed(
            colors, depths, K, poses, TS.SLAMOptions(odom="gt", fusion=True), small,
            watermark=0.85, segment_len=2, policy="evict", min_ccount=1.5, keep_recent=H * W // 2,
        )
        assert torch.all(man_m.num_points <= small)
        assert torch.isfinite(man_m.data).all()

    def test_matches_unmanaged_when_capacity_suffices(self):
        """A watermark never crossed: the segmented loop is the plain loop,
        so the result is bitwise slam_sequence's."""
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        opts = TS.SLAMOptions(odom="gt", fusion=True)
        args = (colors[:, :4], depths[:, :4], K, poses[:, :4], opts, L * H * W)
        ref_m, ref_p = TS.slam_sequence(*args)
        man_m, man_p = TL.slam_sequence_managed(*args, watermark=1.0, segment_len=2)
        assert torch.equal(man_p, ref_p)
        assert torch.equal(man_m.num_points, ref_m.num_points)
        assert torch.equal(man_m.data, ref_m.data)

    def test_option_validation(self):
        colors, depths, K, poses = _t(*_sequence())
        gt = TS.SLAMOptions(odom="gt", fusion=True)
        with pytest.raises(ValueError, match="recency"):
            TL.slam_sequence_managed(
                colors, depths, K, None, TS.SLAMOptions(fusion=False, odom_targets="recent"), 1000
            )
        with pytest.raises(ValueError, match="watermark"):
            TL.slam_sequence_managed(colors, depths, K, poses, gt, 1000, watermark=0.0)
        with pytest.raises(ValueError, match="loop_closure"):
            TL.slam_sequence_managed(colors, depths, K, poses, gt, 1000, loop_closure="nope")
        with pytest.raises(NotImplementedError, match="A12"):
            TL.slam_sequence_managed(colors, depths, K, poses, gt, 1000, loop_closure="both")
        with pytest.raises(ValueError, match="gt odometry"):
            TL.slam_sequence_managed(colors, depths, K, None, gt, 1000)


class TestFusedCompacted:
    def test_aggregate_past_capacity_stays_accurate(self):
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        opts = TS.SLAMOptions(odom="gt", fusion=False)
        ref_m, ref_p = TS.slam_sequence(colors, depths, K, poses, opts, L * H * W)
        man_m, man_p, peak = TL.slam_sequence_compacted(
            colors, depths, K, poses, opts, 2 * H * W, segment_len=1, policy="voxel", voxel_size=0.01,
        )
        assert torch.all(man_m.num_points < 2 * H * W)
        assert int(peak) >= int(man_m.num_points.max())
        assert peak.dtype == torch.int32 and peak.dim() == 0
        assert torch.equal(man_p, ref_p)
        assert _coverage_err(ref_m, man_m) < 0.01

    def test_fusion_gradicp_matches_jax(self):
        c, d, K, _ = _sequence(ds=2)
        B, _, H, W, _ = c.shape
        kw = dict(odom="gradicp", numiters=10, fusion=True)
        small = int(1.2 * H * W)
        lkw = dict(segment_len=2, policy="voxel", voxel_size=VOXEL_2MM)
        _, ref_p = TS.slam_sequence(*_t(c, d, K), None, TS.SLAMOptions(**kw), L * H * W)
        man_m, man_p, peak = TL.slam_sequence_compacted(*_t(c, d, K), None, TS.SLAMOptions(**kw), small, **lkw)
        assert int(peak) <= small
        assert _terr(man_p, ref_p) < 5e-3
        jm, jp, jpeak = JL.slam_sequence_compacted(*_j(c, d, K), None, JS.SLAMOptions(**kw), small, **lkw)
        assert np.abs(man_p.numpy() - np.asarray(jp)).max() < POSE_TOL
        assert int(peak) == int(jpeak)
        assert np.array_equal(man_m.num_points.numpy(), np.asarray(jm.num_points))

    def test_no_compaction_when_segment_covers_sequence(self):
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        opts = TS.SLAMOptions(odom="gt", fusion=True)
        ref_m, ref_p = TS.slam_sequence(colors, depths, K, poses, opts, L * H * W)
        man_m, man_p, peak = TL.slam_sequence_compacted(colors, depths, K, poses, opts, L * H * W, segment_len=L)
        assert torch.equal(man_p, ref_p)
        assert torch.equal(man_m.data, ref_m.data)
        assert int(peak) == int(ref_m.num_points.max())

    @pytest.mark.parametrize("seg", [3, 7])
    def test_remainder_segmentations(self, seg):
        """Every (remainder, segments) split gives L poses (the gt ones) and a
        finite map: the prologue-only, even and remainder paths."""
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        m, p, peak = TL.slam_sequence_compacted(
            colors, depths, K, poses, TS.SLAMOptions(odom="gt", fusion=True), L * H * W, segment_len=seg,
        )
        assert p.shape == (B, L, 4, 4)
        assert torch.equal(p, poses)
        assert torch.isfinite(m.data).all()
        assert int(peak) > 0

    def test_evict_policy(self):
        colors, depths, K, poses = _t(*_sequence())
        B, _, H, W, _ = colors.shape
        small = int(1.2 * H * W)
        m, _, _ = TL.slam_sequence_compacted(
            colors, depths, K, poses, TS.SLAMOptions(odom="gt", fusion=True), small,
            segment_len=2, policy="evict", min_ccount=1.5, keep_recent=H * W // 2,
        )
        assert torch.all(m.num_points <= small)
        assert torch.isfinite(m.data).all()

    def test_option_validation(self):
        colors, depths, K, poses = _t(*_sequence())
        gt = TS.SLAMOptions(odom="gt", fusion=True)
        with pytest.raises(ValueError, match="recency"):
            TL.slam_sequence_compacted(
                colors, depths, K, None, TS.SLAMOptions(fusion=False, odom_targets="recent"), 1000
            )
        with pytest.raises(ValueError, match="segment_len"):
            TL.slam_sequence_compacted(colors, depths, K, poses, gt, 1000, segment_len=0)
        with pytest.raises(ValueError, match="policy"):
            TL.slam_sequence_compacted(colors, depths, K, poses, gt, 1000, policy="nope")


class TestRefresh:
    @pytest.mark.parametrize("model_rows", ["gather", "dense"])
    def test_refresh_matches_jax(self, model_rows):
        """``refresh_slam_state`` on a voxel-compacted state: candidates
        and model rows equal to JAX's, the model image too once JAX's empty
        pixels (2**31 - 1, ``segment_min``'s identity) are read as CAP, the
        value fusion and the port write there; every reader tests ``< CAP``."""
        c, d, K, poses = _sequence(ds=2)
        B, _, H, W, _ = c.shape
        cap = 3 * H * W
        kw = dict(odom="gt", fusion=True, model_rows=model_rows)
        tc, td, tK, tp = _t(c, d, K, poses)
        topts = TS.SLAMOptions(**kw)
        ts = TS.slam_init_state(tc[:, 0], td[:, 0], tK, topts, cap, tp[:, 0])
        ts = TS.slam_step_state(ts, tc[:, 1], td[:, 1], tK, topts, tp[:, 1])
        ts = ts._replace(map_state=voxel_compact_map(ts.map_state, 2.0**-7))
        np_ = lambda x: None if x is None else jnp.asarray(x.numpy())
        js = JS.SLAMState(JMapState(np_(ts.map_state.data), np_(ts.map_state.num_points)),
                          *(np_(getattr(ts, f)) for f in TS.SLAMState._fields[1:]))
        jr = JL.refresh_slam_state(js, jnp.asarray(K), JS.SLAMOptions(**kw), H, W)
        tr = TL.refresh_slam_state(ts, tK, topts, H, W)
        assert np.array_equal(tr.cand_slots.numpy(), np.asarray(jr.cand_slots))
        assert np.array_equal(tr.cand_valid.numpy(), np.asarray(jr.cand_valid))
        assert np.array_equal(tr.app_start.numpy(), np.asarray(jr.app_start))
        jimg = np.asarray(jr.model_img)
        assert (jimg == 2**31 - 1).any() and (jimg < cap).any()
        assert np.array_equal(tr.model_img.numpy(), np.where(jimg >= cap, cap, jimg))
        if model_rows == "dense":
            assert np.array_equal(tr.model_rows.numpy(), np.asarray(jr.model_rows))
        else:
            assert tr.model_rows is None and jr.model_rows is None

    def test_candidates_keep_the_window_width(self):
        """With ``assoc_window`` no larger than the active buffer, the carry
        is the window's width, and a refresh keeps it: the candidates are
        the visible rows inside the window."""
        c, d, K, _ = _t(*_sequence(ds=2))
        B, _, H, W, _ = c.shape
        opts = TS.SLAMOptions(odom="gradicp", numiters=2, fusion=True, assoc_window=H * W)
        cap = 3 * H * W
        assert TS.candidate_capacity(opts, H, W) == (2 * H * W, None)
        assert TS.candidate_capacity(opts, H, W, cap) == (H * W, H * W)
        assert TS.candidate_capacity(dataclasses.replace(opts, assoc_window=3 * H * W - 1), H, W, cap) == (2 * H * W, 3 * H * W - 1)
        st = TS.slam_init_state(c[:, 0], d[:, 0], K, opts, cap)
        st = TS.slam_step_state(st, c[:, 1], d[:, 1], K, opts)
        assert st.cand_slots.shape == (B, H * W)
        rf = TL.refresh_slam_state(st, K, opts, H, W)
        assert rf.cand_slots.shape == (B, H * W)
        assert bool((rf.cand_slots[rf.cand_valid] < H * W).all())


class TestManagedResume:
    """A checkpoint at a boundary where the uninterrupted run compacts,
    reloaded from disk into a fresh state: the continuation equals the
    uninterrupted run bitwise, since compaction rebuilds the caches from
    (arena, pose) as the resume does."""

    @pytest.mark.parametrize(
        "extra", [dict(assoc="projective"), dict(assoc_window="HW")], ids=["projective", "knn assoc_window"]
    )
    def test_resume_equals_uninterrupted(self, tmp_path, extra):
        rgb, dep, K, _ = _t(*_sequence(ds=2))
        B, _, H, W = rgb.shape[:4]
        extra = {k: (H * W if v == "HW" else v) for k, v in extra.items()}
        opts = TS.SLAMOptions(odom="gradicp", numiters=8, dsratio=4, fusion=True, **extra)
        kw = dict(opts=opts, capacity=3 * H * W, watermark=0.1, segment_len=3, policy="voxel", voxel_size=0.02)
        m_full, p_full = TL.slam_sequence_managed(rgb, dep, K, None, **kw)
        m1, p1 = TL.slam_sequence_managed(rgb[:, :4], dep[:, :4], K, None, **kw)
        save_slam_state(str(tmp_path / "seg.npz"), m1, p1[:, -1])
        m_loaded, pose_loaded = load_slam_state(str(tmp_path / "seg.npz"), device="cpu")
        m2, p2 = TL.slam_sequence_managed(rgb[:, 4:], dep[:, 4:], K, None, resume_from=(m_loaded, pose_loaded), **kw)
        assert torch.equal(m2.num_points, m_full.num_points)
        assert torch.equal(m2.data, m_full.data)
        assert torch.equal(p2, p_full[:, 4:])

    def test_jax_checkpoint_resumes_in_the_port(self, tmp_path):
        """A checkpoint written by the JAX package (its npz layout), resumed
        by the port, against JAX's own resume from the same file."""
        from gradslam_tpu.utils import load_slam_state as j_load
        from gradslam_tpu.utils import save_slam_state as j_save

        c, d, K, _ = _sequence(ds=2)
        B, _, H, W = c.shape[:4]
        kw = dict(odom="gradicp", numiters=8, dsratio=4, fusion=True, assoc="projective")
        lkw = dict(capacity=3 * H * W, watermark=0.1, segment_len=3, policy="voxel", voxel_size=2.0**-6)
        m1, p1 = JL.slam_sequence_managed(*_j(c[:, :4], d[:, :4], K), None, opts=JS.SLAMOptions(**kw), **lkw)
        path = str(tmp_path / "jax.npz")
        j_save(path, m1, p1[:, -1])
        jm, jpose = j_load(path)
        jm2, jp2 = JL.slam_sequence_managed(*_j(c[:, 4:], d[:, 4:], K), None, opts=JS.SLAMOptions(**kw),
                                            resume_from=(jm, jpose), **lkw)
        tm, tpose = load_slam_state(path, device="cpu")
        assert tm.data.dtype == torch.float32 and tm.num_points.dtype == torch.int32
        tm2, tp2 = TL.slam_sequence_managed(*_t(c[:, 4:], d[:, 4:], K), None, opts=TS.SLAMOptions(**kw),
                                            resume_from=(tm, tpose), **lkw)
        assert np.abs(tp2.numpy() - np.asarray(jp2)).max() < POSE_TOL
        assert np.array_equal(tm2.num_points.numpy(), np.asarray(jm2.num_points))

    def test_resume_capacity_mismatch_raises(self):
        rgb, dep, K, _ = _t(*_sequence(ds=2))
        opts = TS.SLAMOptions(odom="gradicp", numiters=2, fusion=True)
        with pytest.raises(ValueError, match="capacity"):
            TL.slam_sequence_managed(
                rgb[:, :2], dep[:, :2], K, None, opts=opts, capacity=999,
                resume_from=(init_map(2, 100, device="cpu"), torch.eye(4).repeat(2, 1, 1)),
            )
