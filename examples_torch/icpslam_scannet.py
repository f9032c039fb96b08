"""ICP-SLAM on ScanNet scenes (reference examples/icpslam_scannet.py), on
the PyTorch / CUDA port: the twin of ``examples/icpslam_scannet.py``, plus
``--device`` (default ``cuda``)."""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

from gradslam_tpu_torch import ICPSLAM, RGBDImages
from gradslam_tpu_torch.datasets import Scannet
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.utils import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--scannet_path", required=True)
parser.add_argument("--scannet_meta_path", required=True)
parser.add_argument("--scenes", default=None, help="comma-separated scene names")
parser.add_argument(
    "--odometry", choices=["gt", "icp", "gradicp"], default="gradicp"
)
parser.add_argument("--start", type=int, default=0)
parser.add_argument("--end", type=int, default=16)
parser.add_argument("--height", type=int, default=240)
parser.add_argument("--width", type=int, default=320)
parser.add_argument("--plot", action="store_true")
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    args = parser.parse_args()
    device = resolve_device(args.device)
    scenes = tuple(args.scenes.split(",")) if args.scenes else None
    dataset = Scannet(
        args.scannet_path,
        args.scannet_meta_path,
        scenes,
        start=args.start,
        end=args.end,
        height=args.height,
        width=args.width,
    )
    colors, depths, intrinsics, poses, *_ = dataset[0]
    rgbdimages = RGBDImages(
        colors[None], depths[None], intrinsics[None], poses[None], device=device
    )
    slam = ICPSLAM(odom=args.odometry, device=device)
    pointclouds, recovered_poses = slam(rgbdimages)
    print(f"map points: {pointclouds.num_points_per_pointcloud.cpu().numpy()}")
    print(
        "ATE-RMSE vs dataset poses:",
        ate_rmse(recovered_poses, rgbdimages.poses).cpu().numpy(),
    )
    if args.plot:
        pointclouds.plotly(0).show()


if __name__ == "__main__":
    main()
