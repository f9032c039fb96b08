"""The port's projective-association PointFusion against the JAX package,
and twins of the JAX package's tests of that path.

``slam_sequence`` (gradicp, ``assoc='projective'``, L=3 of the msrd clip)
runs in both packages from the same numpy inputs, at the golden point's
configuration (window 2*H*W = A, so the view is not compacted; model rows
gathered) and at the ScanNet point's (window 3*H*W > A = 1.5*H*W, gated
compaction, dense model rows). Tolerances: poses within 2e-4 (measured gap
~1.1e-6: float32 sums in another order) and ``num_points`` identical.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch import ICPSLAM, PointFusion, RGBDImages, init_map
from gradslam_tpu_torch.slam import icpslam as TS

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32)
            for n in ("colors", "depths", "intrinsics", "poses")}


@pytest.fixture
def rgbd(clip):
    return RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], clip["poses"], device="cpu")


CONFIGS = {
    "golden": dict(assoc_window=2 * H * W),
    "scannet": dict(assoc_window=3 * H * W, active_capacity=(3 * H * W) // 2, model_rows="dense"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_projective_slam_sequence_matches_jax(clip, config):
    L = 3
    kw = dict(odom="gradicp", fusion=True, assoc="projective", **CONFIGS[config])
    c, d, K = clip["colors"], clip["depths"], clip["intrinsics"]
    mj, pj = JS.slam_sequence(jnp.asarray(c), jnp.asarray(d), jnp.asarray(K), None,
                              JS.SLAMOptions(**kw), 4 * H * W)
    mt, pt = TS.slam_sequence(torch.from_numpy(c), torch.from_numpy(d), torch.from_numpy(K), None,
                              TS.SLAMOptions(**kw), 4 * H * W)
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 2e-4
    np.testing.assert_array_equal(mt.num_points.numpy(), np.asarray(mj.num_points))
    assert int(mt.num_points.max()) <= kw["assoc_window"]  # the window held the map


def _pose_errors(poses, gt):
    terr = np.linalg.norm(poses[..., :3, 3] - gt[..., :3, 3], axis=-1)
    cos = (np.einsum("blij,blij->bl", poses[..., :3, :3], gt[..., :3, :3]) - 1.0) / 2.0
    return terr.max(), np.degrees(np.arccos(np.clip(cos, -1, 1))).max()


@pytest.mark.parametrize("odom", ["gradicp", "icp"])
def test_trajectory_close_to_gt(rgbd, clip, odom):
    """Twin of TestProjectiveAssociation::test_trajectory_close_to_gt."""
    _, poses = PointFusion(odom=odom, numiters=10, assoc="projective", device="cpu")(rgbd)
    terr, ang = _pose_errors(poses.numpy(), clip["poses"])
    assert terr < 0.02, f"translation error {terr}"
    assert ang < 2.0, f"rotation error {ang} deg"


def test_state_api_matches_sequence(rgbd):
    """Twin of TestProjectiveAssociation::test_state_api_matches_sequence:
    the carried model image advances identically through the state API and
    the sequence."""
    slam = PointFusion(odom="gradicp", numiters=6, assoc="projective", device="cpu")
    B, L, H_, W_ = rgbd.shape
    state = slam.init_state(rgbd[:, 0], capacity=L * H_ * W_)
    poses_inc = [state.pose.numpy()]
    for s in range(1, L):
        state = slam.step_state(state, rgbd[:, s])
        poses_inc.append(state.pose.numpy())
    _, poses_fwd = slam(rgbd)
    np.testing.assert_allclose(np.stack(poses_inc, axis=1), poses_fwd.numpy(), atol=1e-6)


def test_model_rows_carried_through_the_state(rgbd):
    """With dense model rows the state carries the (B, H*W, 7) target rows,
    and the poses equal those of the gathered model image."""
    poses = {}
    for mode in ("gather", "dense"):
        slam = PointFusion(odom="gradicp", numiters=6, assoc="projective", model_rows=mode, device="cpu")
        state = slam.init_state(rgbd[:, 0], capacity=3 * H * W)
        assert (state.model_rows is None) == (mode == "gather")
        if mode == "dense":
            assert tuple(state.model_rows.shape) == (2, H * W, 7)
            back = TS.slam_state_from_numpy(**TS.slam_state_to_numpy(state), device="cpu")
            assert torch.equal(back.model_rows, state.model_rows)
        poses[mode] = slam.step_state(state, rgbd[:, 1]).pose.numpy()
    np.testing.assert_allclose(poses["dense"], poses["gather"], atol=1e-6)


def test_windowed_odometry_matches_full_arena(rgbd, clip):
    """Twin of TestAssocWindowOdometry::test_windowed_odometry_matches_full_arena:
    fusion, real odometry and no carried candidates take the odometry
    targets from the window; every live row fits it here, so the trajectory
    equals the full arena's."""
    out = {}
    for aw in (0, 2 * H * W):
        slam = PointFusion(odom="gradicp", numiters=10, assoc_window=aw, reuse_actives=False, device="cpu")
        out[aw] = slam(rgbd)[1].numpy()
    np.testing.assert_allclose(out[0], out[2 * H * W], rtol=1e-5, atol=1e-6)
    assert _pose_errors(out[2 * H * W], clip["poses"])[0] < 0.02


def test_requires_fusion():
    with pytest.raises(ValueError, match="projective"):
        ICPSLAM(odom="gradicp", assoc="projective", device="cpu")


def test_slam_step_rejects_projective():
    opts = TS.SLAMOptions(odom="gradicp", fusion=True, assoc="projective")
    eye = torch.eye(4)
    with pytest.raises(ValueError, match="model image"):
        TS.slam_step(init_map(1, 1024, device="cpu"), eye.expand(1, 4, 4), torch.zeros((1, 8, 8, 3)),
                     torch.ones((1, 8, 8, 1)), eye.expand(1, 1, 4, 4), opts)


def test_aggregate_rejects_assoc_window():
    with pytest.raises(ValueError, match="assoc_window"):
        ICPSLAM(odom="gradicp", assoc_window=4096, device="cpu")


def test_rejects_bad_model_rows():
    with pytest.raises(ValueError, match="model_rows"):
        PointFusion(odom="gradicp", model_rows="bogus", device="cpu")
    PointFusion(odom="gradicp", model_rows="dense", device="cpu")
    PointFusion(odom="gradicp", model_rows="gather", device="cpu")


def test_rejects_bad_window_merge():
    with pytest.raises(ValueError, match="window_merge"):
        PointFusion(odom="gradicp", window_merge="bogus", device="cpu")
    PointFusion(odom="gradicp", window_merge="rows", device="cpu")


def test_rejects_assoc_window_with_block_size():
    with pytest.raises(ValueError, match="mutually exclusive"):
        PointFusion(odom="gradicp", assoc_window=4096, block_size=1024, device="cpu")


def test_rejects_explicit_merge_window_with_assoc_window():
    with pytest.raises(ValueError, match="merge_window"):
        PointFusion(odom="gradicp", assoc_window=4096, merge_window=8192, device="cpu")
    # auto (-1) and off (0) remain fine
    PointFusion(odom="gradicp", assoc_window=4096, merge_window=-1, device="cpu")
    PointFusion(odom="gradicp", assoc_window=4096, merge_window=0, device="cpu")
