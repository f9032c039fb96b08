"""The port against the real gradslam's goldens: the torch twin of
tests/slam/test_reference_parity.py, with the same tolerances.

PointFusion on the msrd golden clip (B=2, L=10, 120x160, the clip cycled as
there), gt, gradicp and icp odometry, on the CPU. The known divergence is the
same as the JAX package's: the port gives degenerate pixels the exact zero
normal where the reference normalizes cross-product noise, which shifts
append counts by a few percent without moving the trajectory.
"""

import json
import pathlib

import numpy as np
import torch

from gradslam_tpu_torch.slam.icpslam import SLAMOptions, slam_sequence

torch.set_num_threads(2)

GOLDEN_DIR = pathlib.Path(__file__).parent / "data" / "reference_goldens"
DATA_DIR = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
B, L = 2, 10
H, W = 120, 160


def _load_sequence():
    colors = np.load(DATA_DIR / "colors.npy")
    depths = np.load(DATA_DIR / "depths.npy")
    idx = [i % colors.shape[1] for i in range(L)]
    K = np.load(DATA_DIR / "intrinsics.npy")
    poses = np.load(DATA_DIR / "poses.npy")
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        for x in (colors[:, idx], depths[:, idx], K, poses[:, idx])
    )


def _run(odom, with_poses):
    colors, depths, K, poses = _load_sequence()
    opts = SLAMOptions(odom=odom, assoc="knn", numiters=20, dsratio=4, fusion=True)
    m, p = slam_sequence(colors, depths, K, poses if with_poses else None, opts, L * H * W)
    return m, p.numpy()


def _golden(odom):
    return np.load(GOLDEN_DIR / f"pointfusion_{odom}.npz")


def _symmetric_nn_stats(a, b):
    from scipy.spatial import cKDTree

    d = np.concatenate([cKDTree(b).query(a)[0], cKDTree(a).query(b)[0]])
    return np.median(d), np.percentile(d, 99)


def _check_map(m, g, med_tol, p99_tol):
    npts = m.num_points.numpy()
    ref_np = g["num_points"]
    assert np.all(np.abs(npts - ref_np) <= 0.05 * ref_np), (npts, ref_np)
    for b in range(B):
        ours = m.points[b, : npts[b]].numpy()
        med, p99 = _symmetric_nn_stats(ours, g["points"][b][: ref_np[b]])
        assert med < med_tol, (b, med)
        assert p99 < p99_tol, (b, p99)


def test_goldens_provenance():
    meta = json.loads((GOLDEN_DIR / "meta.json").read_text())
    assert meta["B"] == B and meta["L"] == L
    assert meta["dsratio"] == 4 and meta["numiters"] == 20


def test_gt_fusion_matches_reference():
    m, p = _run("gt", with_poses=True)
    g = _golden("gt")
    np.testing.assert_allclose(p, g["poses"], atol=1e-6)
    _, depths, _, _ = _load_sequence()
    valid0 = (depths[:, 0, ..., 0] > 0).sum(dim=(1, 2)).numpy()
    assert np.all(m.num_points.numpy() >= valid0)
    _check_map(m, g, med_tol=1e-4, p99_tol=5e-3)


def test_gradicp_trajectory_matches_reference():
    m, p = _run("gradicp", with_poses=False)
    g = _golden("gradicp")
    # the JAX package measured 8.6e-4 here; so does the port
    assert np.abs(p - g["poses"]).max() < 2e-3
    _check_map(m, g, med_tol=2e-4, p99_tol=1e-2)



def test_icp_trajectory_matches_reference():
    m, p = _run("icp", with_poses=False)
    g = _golden("icp")
    assert np.abs(p - g["poses"]).max() < 2e-3
    _check_map(m, g, med_tol=2e-4, p99_tol=1e-2)
