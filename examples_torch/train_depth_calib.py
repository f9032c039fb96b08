"""End-to-end differentiable SLAM on the PyTorch / CUDA port: optimize
depth calibration parameters (the twin of ``examples/train_depth_calib.py``,
plus ``--device``, default ``cuda``).

The BASELINE "stretch" config: backprop a trajectory loss through the
whole SLAM pipeline (gradICP odometry + PointFusion) to recover sensor
depth-calibration parameters (scale/bias). Demonstrates that gradients
flow from the recovered trajectory back to raw sensor inputs — the core
property of differentiable SLAM. Neither hand-written kernel has a
backward: autograd differentiates the gathers, solves and merges around
the KNN and the fusion winners. On the card each step (forward, backward
and update) is one captured CUDA graph, as its JAX twin jits the step;
the learning rate is a device tensor the graph reads, so the schedule
replays the same graph.

Runs out of the box on the golden clip:

    python examples_torch/train_depth_calib.py --steps 30
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

import numpy as np
import torch

from gradslam_tpu_torch import GradStep
from gradslam_tpu_torch.parallel import DepthCalibParams
from gradslam_tpu_torch.parallel.sharded import slam_loss
from gradslam_tpu_torch.slam.icpslam import SLAMOptions, slam_sequence
from gradslam_tpu_torch.utils import resolve_device

DATA = pathlib.Path(__file__).parents[1] / "tests" / "data" / "msrd_b2s3"

parser = argparse.ArgumentParser()
parser.add_argument("--steps", type=int, default=30)
parser.add_argument("--lr", type=float, default=0.05)
parser.add_argument("--true_scale", type=float, default=1.1)
parser.add_argument("--init_scale", type=float, default=1.0)
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    args = parser.parse_args()
    device = resolve_device(args.device)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    # half resolution keeps the reverse-mode graph small for a demo
    colors = on(np.load(DATA / "colors.npy")[:1, :, ::2, ::2])
    depths_clean = on(np.load(DATA / "depths.npy")[:1, :, ::2, ::2])
    K = np.load(DATA / "intrinsics.npy")[:1].astype(np.float32)
    K[:, :, :2] *= 0.5
    K = on(K)
    B, L, H, W, _ = colors.shape

    # simulate a miscalibrated sensor: observed depth = true / true_scale
    depths_observed = depths_clean / args.true_scale

    opts = SLAMOptions(odom="gradicp", numiters=5, fusion=True)
    capacity = L * H * W

    # reference trajectory from the calibrated sensor: the optimization
    # target is exactly reproducible at the true scale (zero-noise optimum)
    with torch.no_grad():
        _, gt_poses = slam_sequence(
            colors, depths_clean, K, None, opts, capacity
        )

    def sgd(params, lr):
        loss = slam_loss(
            params, colors, depths_observed, K, gt_poses, opts, capacity
        )
        (grad,) = torch.autograd.grad(loss, [params.scale])
        # normalized gradient step on the scale parameter (the raw
        # gradient magnitude depends on the tiny trajectory scale; the
        # sign/direction is what matters for this 1-D demo). Bias is kept
        # fixed: scale and bias are strongly coupled on a single clip.
        with torch.no_grad():
            return params.scale - lr * grad / (grad.abs() + 1e-20), loss.detach()

    step = GradStep(sgd)
    params = DepthCalibParams(scale=args.init_scale, device=device)
    lr = torch.zeros((), device=device)
    for i in range(args.steps):
        lr.fill_(args.lr * (0.5 ** (i / max(args.steps / 3, 1))))
        scale, loss = step(params, lr)
        with torch.no_grad():
            params.scale.copy_(scale)
        if i % 5 == 0 or i == args.steps - 1:
            print(
                f"step {i:3d}: loss {float(loss):.3e} "
                f"scale {float(params.scale.detach()):.4f} "
                f"bias {float(params.bias.detach()):+.5f}"
            )
    print(
        f"\nrecovered scale {float(params.scale.detach()):.4f} "
        f"(true {args.true_scale}); residual "
        f"{abs(float(params.scale.detach()) - args.true_scale):.4f}"
    )


if __name__ == "__main__":
    main()
