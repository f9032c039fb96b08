"""Evaluate SLAM trajectory accuracy (ATE-RMSE / RPE) on a dataset, on the
PyTorch / CUDA port: the twin of ``examples/evaluate_ate.py``, plus
``--device`` (default ``cuda``).

Point this at extracted TUM (or ICL) data:

    python examples_torch/evaluate_ate.py --dataset tum --dataset_path /data/TUM \
        --sequences rgbd_dataset_freiburg1_desk --seqlen 20 --odometry gradicp
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

import numpy as np

from gradslam_tpu_torch import ICPSLAM, PointFusion, RGBDImages
from gradslam_tpu_torch.datasets import ICL, TUM
from gradslam_tpu_torch.metrics import ate_rmse, rpe
from gradslam_tpu_torch.utils import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--dataset", choices=["tum", "icl"], default="tum")
parser.add_argument("--dataset_path", required=True)
parser.add_argument("--sequences", default=None)
parser.add_argument(
    "--odometry", choices=["icp", "gradicp"], default="gradicp"
)
parser.add_argument(
    "--slam", choices=["pointfusion", "icpslam"], default="pointfusion"
)
parser.add_argument("--seqlen", type=int, default=20)
parser.add_argument("--height", type=int, default=120)
parser.add_argument("--width", type=int, default=160)
parser.add_argument("--dsratio", type=int, default=4)
parser.add_argument("--numiters", type=int, default=20)
parser.add_argument("--max_sequences", type=int, default=8)
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    args = parser.parse_args()
    device = resolve_device(args.device)
    sequences = tuple(args.sequences.split(",")) if args.sequences else None
    ds_cls = TUM if args.dataset == "tum" else ICL
    dataset = ds_cls(
        args.dataset_path,
        sequences,
        seqlen=args.seqlen,
        height=args.height,
        width=args.width,
    )
    slam_cls = PointFusion if args.slam == "pointfusion" else ICPSLAM
    slam = slam_cls(
        odom=args.odometry, dsratio=args.dsratio, numiters=args.numiters,
        device=device,
    )

    ates, rpes_t, rpes_r = [], [], []
    for i in range(min(len(dataset), args.max_sequences)):
        colors, depths, K, poses, *_ = dataset[i]
        rgbd = RGBDImages(
            colors[None], depths[None], K[None], poses[None], device=device
        )
        _, recovered = slam(rgbd)
        ates.append(float(ate_rmse(recovered[0], rgbd.poses[0])))
        t, r = rpe(recovered[0], rgbd.poses[0])
        rpes_t.append(float(t))
        rpes_r.append(float(r))
        print(
            f"seq {i}: ATE-RMSE {ates[-1]:.4f} m, "
            f"RPE {rpes_t[-1]:.4f} m / {np.degrees(rpes_r[-1]):.3f} deg"
        )
    print(
        f"mean over {len(ates)} windows: ATE-RMSE {np.mean(ates):.4f} m, "
        f"RPE {np.mean(rpes_t):.4f} m / {np.degrees(np.mean(rpes_r)):.3f} deg"
    )


if __name__ == "__main__":
    main()
