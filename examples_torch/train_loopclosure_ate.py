"""Differentiable loop closure on the PyTorch / CUDA port: train a sensor
calibration against post-loop-closure ATE (the twin of
``examples/train_loopclosure_ate.py``, plus ``--device``, default ``cuda``;
``--cpu`` is ``--device cpu``).

The refinement stack (batched gradICP verification + pose-graph
Gauss-Newton, gradslam_tpu_torch/slam/loopclosure.py) is differentiable end
to end, so a trajectory-level metric computed AFTER loop closure can
supervise upstream sensor parameters. Here a range-scale miscalibration
is applied to every frame's point cloud (depth sensor reporting ranges
scaled by an unknown factor); the loss is the ATE-RMSE of the
loop-closed trajectory against ground truth, and gradient descent
recovers the true scale:

    loss = ATE(close_loops(drifted_poses, s * points, ...), gt)
    ds = d loss / d s        # flows through GN + ICP + detection gates

Candidate selection (top_k) and accept thresholds are piecewise-constant
and act as locally-constant gates; the ICP measurements and the
pose-graph solve carry the gradient (see
tests/test_torch_loopclosure_grad.py). On the card each step (the closure,
the loss, the backward and the update) is one captured CUDA graph
(``GradStep``), as its JAX twin jits ``value_and_grad``.

    python examples_torch/train_loopclosure_ate.py [--steps 25]
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse

import numpy as np
import torch

from gradslam_tpu_torch import GradStep
from gradslam_tpu_torch.geometry import se3_exp
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.slam import close_loops
from gradslam_tpu_torch.utils import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--frames", type=int, default=13)
parser.add_argument("--points", type=int, default=256)
parser.add_argument("--drift", type=float, default=0.02)
parser.add_argument("--true_scale", type=float, default=1.15)
parser.add_argument("--steps", type=int, default=25)
parser.add_argument("--lr", type=float, default=0.4)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU: the same as --device cpu")
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def make_problem(frames, points, drift, true_scale, seed, device):
    """The drifted loop: (drifted poses (L, 4, 4), observed points (L, N, 3),
    normals (L, N, 3), valid (L, N), ground-truth poses (L, 4, 4)) on
    ``device``."""
    rng = np.random.RandomState(seed)
    L, N = frames, points

    # world cloud + circular trajectory closing on itself (as in
    # examples_torch/loop_closure.py)
    world = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    world[:, 2] += 4.0
    normals = rng.randn(N, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)

    true_poses, pts, nrms = [], [], []
    for k in range(L):
        ang = 2 * np.pi * k / (L - 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = 0.2 * np.array([np.cos(ang) - 1.0, np.sin(ang), 0.0])
        true_poses.append(T)
        Tinv = np.linalg.inv(T)
        pts.append(world @ Tinv[:3, :3].T + Tinv[:3, 3])
        nrms.append(normals @ Tinv[:3, :3].T)
    true_poses = np.stack(true_poses)

    drifted = [true_poses[0]]
    for k in range(1, L):
        inc = np.linalg.inv(true_poses[k - 1]) @ true_poses[k]
        xi = rng.randn(6).astype(np.float32) * drift
        drifted.append(drifted[-1] @ (se3_exp(torch.from_numpy(xi)).numpy() @ inc))

    on = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    valid = torch.ones((L, N), dtype=torch.bool, device=device)
    # the "sensor" reports ranges divided by the unknown true scale
    return on(np.stack(drifted)), on(np.stack(pts)) / true_scale, on(np.stack(nrms)), valid, on(true_poses)


def loss_fn(log_s, drifted, pts_observed, normals, valid, gt):
    """The post-closure ATE of the trajectory closed on ``exp(log_s)``
    times the observed points: (loss, loop weights)."""
    L = drifted.shape[0]
    refined, _, w = close_loops(
        drifted, torch.exp(log_s) * pts_observed, normals, valid,
        max_candidates=8, min_separation=max(3, L // 3), max_distance=0.3,
        icp_numiters=8, refine_iters=5,
    )
    return ate_rmse(refined, gt, align=False), w


def sgd(log_s, lr, *problem):
    """One training step, the twin of the JAX example's jitted
    ``value_and_grad`` and its update: (new log_s, loss, loop weights)."""
    loss, w = loss_fn(log_s, *problem)
    (g,) = torch.autograd.grad(loss, [log_s])
    with torch.no_grad():
        return log_s - lr * g, loss.detach(), w


def main():
    args = parser.parse_args()
    device = resolve_device("cpu" if args.cpu else args.device)
    problem = make_problem(args.frames, args.points, args.drift, args.true_scale, args.seed, device)

    # on the card the step (closure, loss, backward and update) is one
    # captured CUDA graph; the learning rate is a device tensor it reads
    step = GradStep(sgd)
    log_s = torch.zeros((), device=device)  # scale 1.0
    lr = torch.full((), args.lr, device=device)
    for i in range(args.steps):
        log_s, loss, w = step(log_s, lr, *problem)
        if i % 5 == 0 or i == args.steps - 1:
            print(
                f"step {i:3d}: post-closure ATE {float(loss):.5f} m, "
                f"scale {float(torch.exp(log_s)):.4f} "
                f"(true {args.true_scale}), loop edges "
                f"{int((w > 0).sum())}"
            )

    final = float(torch.exp(log_s))
    print(
        f"recovered range scale {final:.4f} (true {args.true_scale}); "
        f"rel err {abs(final - args.true_scale) / args.true_scale:.3%}"
    )


if __name__ == "__main__":
    main()
