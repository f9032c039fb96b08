"""Tutorial: PointFusion SLAM end to end, on the PyTorch / CUDA port.

Mirrors the reference's pointfusion tutorial notebook as a runnable
script (the twin of ``examples/tutorials/pointfusion_tutorial.py``), using
the golden RGB-D clip shipped with the tests (no dataset download
needed). Runs on ``--device`` (default ``cuda``).
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import argparse

from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.utils import resolve_device

import numpy as np

DATA = pathlib.Path(__file__).parents[2] / "tests" / "data" / "msrd_b2s3"

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    device = resolve_device(parser.parse_args().device)
    # 1. Load a batch of RGB-D sequences: colors (B, L, H, W, 3),
    #    depths (B, L, H, W, 1), intrinsics (B, 1, 4, 4), poses (B, L, 4, 4)
    colors = np.load(DATA / "colors.npy")
    depths = np.load(DATA / "depths.npy")
    intrinsics = np.load(DATA / "intrinsics.npy")
    poses = np.load(DATA / "poses.npy")

    # 2. Wrap them as RGBDImages on the device — derived maps (vertex/normal,
    #    local and global) are computed lazily and cached.
    rgbdimages = RGBDImages(colors, depths, intrinsics, poses, device=device)
    print("vertex map:", rgbdimages.vertex_map.shape)
    print("normal map:", rgbdimages.normal_map.shape)

    # 3. Run PointFusion with gradICP odometry. The frames run one after
    #    another in an eager loop on the device; each frame's odometry
    #    calls the hand-written KNN kernel and its fusion step the per-pixel
    #    winner kernel, and the map lives in a fixed-capacity arena.
    slam = PointFusion(odom="gradicp", numiters=10, device=device)
    pointclouds, recovered_poses = slam(rgbdimages)

    print("map points per batch:", pointclouds.num_points_per_pointcloud.cpu().numpy())
    print("recovered poses:", recovered_poses.shape)

    # 4. Evaluate against the dataset's ground-truth trajectory.
    print("ATE-RMSE:", ate_rmse(recovered_poses, rgbdimages.poses).cpu().numpy())

    # 5. Export / visualize (requires plotly or open3d):
    #    pointclouds.plotly(0).show()
    #    o3d_pcd = pointclouds.open3d(0)


if __name__ == "__main__":
    main()
