"""ICP-SLAM with loop closure against the benchmark's plain reference
(``slam_bench/reference/icpslam_loop.py``) on the CPU.

A whole rendered loop of 100 frames through
``ICPSLAM(odom_targets='recent', loop_closure='both')`` at 24x32, with the
loop cell's detection gates and, to suit the size, every second pixel
(odometry and clouds), 10 iterations of each ICP and an inlier distance of
0.15 m (the clouds are ten times sparser than the cell's at 480x640). At
this seed both detectors accept pairs and the closure moves the trajectory
by decimetres; the two are written apart, so they agree to rounding.
"""

import torch

from gradslam_tpu_torch import ICPSLAM, RGBDImages
from slam_bench import compare
from slam_bench.inputs import render
from slam_bench.reference import Options
from slam_bench.reference import icpslam_loop as ref

torch.set_num_threads(2)

H, W, FX = 24, 32, 26.25  # TUM's 525 at 640 columns
GATES = dict(min_separation=25, max_distance=0.36)
SMALL = dict(dsratio=2, icp_numiters=10, inlier_dist=0.15)


def test_the_closed_loop_agrees_with_the_reference():
    c, d, K, _ = render.render_arcs(5, 1, 100, H, W, (FX, FX, (W - 1) / 2, (H - 1) / 2), 100, 0.55, 0.002, "cpu")
    slam = ICPSLAM(odom_targets="recent", loop_closure="both", loop_closure_kwargs=dict(GATES, **SMALL),
                   dsratio=2, numiters=10, device="cpu")
    pcs, poses = slam(RGBDImages(c, d, K, device="cpu"))
    opts = Options(dsratio=2, numiters=10)
    with torch.no_grad():
        odometry, rows = ref.odometry_and_map(c[0], d[0], K[0].reshape(4, 4), opts)
        closed, pairs = ref.close(c[0], d[0], K[0].reshape(4, 4), odometry, opts,
                                  ref.Closure(detection="both", **GATES, **SMALL))
    assert any(j - i < 90 for i, j in pairs) and any(j - i >= 90 for i, j in pairs), pairs
    assert compare.pose_gaps(odometry, closed)["pose_gap_m"] > 0.1  # the closure moves the trajectory
    gaps = compare.pose_gaps(poses[0], closed)
    assert gaps["pose_gap_m"] < 1e-4 and gaps["pose_gap_deg"] < 1e-3, gaps
    assert int(pcs.num_points_per_pointcloud[0]) == rows.shape[0]
