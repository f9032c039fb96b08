"""PointFusion on ScanNet scenes (reference examples/pointfusion_scannet.py),
on the PyTorch / CUDA port: the twin of ``examples/pointfusion_scannet.py``,
plus ``--device`` (default ``cuda``). A frame size other than the files'
own needs OpenCV to resize.

Example:
    python examples_torch/pointfusion_scannet.py \
        --scannet_path extractions/scans \
        --scannet_meta_path extractions/sequence_associations \
        --odometry gradicp
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

import numpy as np
import torch

from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.datasets import Scannet, get_color_encoding
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.slam.icpslam import slam_sequence
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
parser.add_argument(
    "--assoc", default="knn", choices=("knn", "projective"),
    help="odometry data association (projective: fast path)",
)
parser.add_argument(
    "--assoc_window", type=int, default=0,
    help="association working-set bound in arena rows "
    "(0 = exact full arena; see docs/TUNING.md)",
)
parser.add_argument(
    "--semantic_ply",
    default=None,
    help="fuse the ScanNet semantic labels into the map and write a "
    "label-colored PLY here",
)
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
    sample = dataset[0]
    colors, depths, intrinsics, poses = sample[0], sample[1], sample[2], sample[3]
    labels = sample[-1] if dataset.return_labels else None
    rgbdimages = RGBDImages(
        colors[None], depths[None], intrinsics[None], poses[None], device=device
    )
    slam = PointFusion(
        odom=args.odometry, assoc=args.assoc,
        assoc_window=args.assoc_window, device=device,
    )

    if args.semantic_ply and labels is not None:
        # semantic mapping: fuse labels into the arena's label channels
        rgbd = rgbdimages.to_channels_last()
        L, H, W = rgbd.shape[1:]
        m, recovered_poses = slam_sequence(
            rgbd.rgb_image,
            rgbd.depth_image,
            rgbd.intrinsics,
            rgbd.poses if args.odometry == "gt" else None,
            slam.opts,
            slam.opts.map_capacity or L * H * W,
            labels_seq=torch.as_tensor(
                labels[None, ..., 0] if labels.ndim == 4 else labels[None],
                device=device,
            ),
        )
        from gradslam_tpu_torch.structures import map_to_pointclouds
        from gradslam_tpu_torch.viz.ply import write_ply

        pointclouds = map_to_pointclouds(m)
        n = int(m.num_points[0])
        palette = get_color_encoding(dataset.seg_classes)
        lut = np.zeros((max(41, len(palette) + 1), 3), np.float32)
        for i, (_, rgb) in enumerate(palette.items()):
            lut[i] = np.asarray(rgb, np.float32) / 255.0
        labs = np.clip(
            m.labels[0][:n].cpu().numpy().astype(int), 0, len(lut) - 1
        )
        write_ply(
            args.semantic_ply,
            m.points[0][:n].cpu().numpy(),
            colors=lut[labs],
        )
        print(f"semantic PLY written to {args.semantic_ply} ({n} points)")
    else:
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
