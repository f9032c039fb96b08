"""PointFusion on TUM/ICL sequences (reference examples/pointfusion.py), on
the PyTorch / CUDA port: the twin of ``examples/pointfusion.py``, with the
same flags and output lines, plus ``--device`` (default ``cuda``; without a
card it exits with an error unless given ``--device cpu``).

Example:
    python examples_torch/pointfusion.py --dataset tum --dataset_path /data/TUM \
        --odometry gradicp --seqlen 10
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.datasets import ICL, TUM, DataLoader
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.utils import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument(
    "--dataset", choices=["tum", "icl"], default="tum", help="dataset to use"
)
parser.add_argument("--dataset_path", required=True, help="dataset base dir")
parser.add_argument(
    "--odometry",
    choices=["gt", "icp", "gradicp"],
    default="gradicp",
    help="odometry method",
)
parser.add_argument("--sequences", default=None, help="comma-separated names")
parser.add_argument("--seqlen", type=int, default=10)
parser.add_argument("--batch_size", type=int, default=2)
parser.add_argument("--height", type=int, default=120)
parser.add_argument("--width", type=int, default=160)
parser.add_argument("--dsratio", type=int, default=4)
parser.add_argument("--numiters", type=int, default=20)
parser.add_argument(
    "--assoc", default="knn", choices=("knn", "projective"),
    help="odometry data association (projective: fast path)",
)
parser.add_argument(
    "--assoc_window", type=int, default=0,
    help="association working-set bound in arena rows "
    "(0 = exact full arena; see docs/TUNING.md)",
)
parser.add_argument("--plot", action="store_true", help="show plotly figure")
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    args = parser.parse_args()
    device = resolve_device(args.device)
    sequences = (
        tuple(args.sequences.split(",")) if args.sequences else None
    )
    ds_cls = TUM if args.dataset == "tum" else ICL
    dataset = ds_cls(
        args.dataset_path,
        sequences,
        seqlen=args.seqlen,
        height=args.height,
        width=args.width,
    )

    loader = DataLoader(
        dataset,
        batch_size=min(args.batch_size, len(dataset)),
        num_workers=4,
        drop_last=False,
        to_device=device,
    )
    colors, depths, intrinsics, poses, *_ = next(iter(loader))

    rgbdimages = RGBDImages(colors, depths, intrinsics, poses, device=device)
    slam = PointFusion(
        odom=args.odometry, dsratio=args.dsratio,
        numiters=args.numiters, assoc=args.assoc,
        assoc_window=args.assoc_window, device=device,
    )
    pointclouds, recovered_poses = slam(rgbdimages)

    ate = ate_rmse(recovered_poses, rgbdimages.poses)
    print(f"map points per batch: {pointclouds.num_points_per_pointcloud.cpu().numpy()}")
    print(f"ATE-RMSE vs dataset poses: {ate.cpu().numpy()}")
    if args.plot:
        pointclouds.plotly(0).show()


if __name__ == "__main__":
    main()
