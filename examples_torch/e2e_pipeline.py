"""End-to-end pipeline demo on the PyTorch / CUDA port: TUM files on disk
-> ATE, through the full production chain (the twin of
``examples/e2e_pipeline.py``):

    TUM loader (C++ native PNG decode, else imageio or Pillow) ->
    DataLoader(num_workers, prefetch, to_device) -> slam_sequence_managed
    -> close_loops_rgbd -> ate_rmse

Point it at a real TUM sequence directory, or run with no arguments to
render a small geometrically coherent RGB-D sequence (textured bumpy
surface, known trajectory, exact ray-cast depth), write it in the TUM
on-disk format, and run the chain on that:

    python examples_torch/e2e_pipeline.py [--basedir /data/TUM] [--seqlen 8]

Runs on ``--device`` (default ``cuda``); ``--cpu`` is ``--device cpu``.
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import tempfile
import time

import numpy as np

from gradslam_tpu_torch.datasets import TUM, DataLoader, imagefile, native_loader
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence_managed
from gradslam_tpu_torch.slam.loopclosure import close_loops_rgbd
from gradslam_tpu_torch.utils import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--basedir", default="", help="TUM dataset root "
                    "(default: render + write a synthetic sequence)")
parser.add_argument("--seqlen", type=int, default=6)
parser.add_argument("--height", type=int, default=48)
parser.add_argument("--width", type=int, default=64)
parser.add_argument("--numiters", type=int, default=12)
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU: the same as --device cpu")
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def render_tum_tree(root, n_frames=12, H=48, W=64):
    """Ray-casts a textured bumpy surface from a translating camera and
    writes it in the TUM on-disk format (16-bit depth PNGs at scale
    5000, 8-bit color, rgb/depth/groundtruth txt)."""
    fx = fy = 525.0 * W / 640.0
    cx, cy = 319.5 * W / 640.0, 239.5 * H / 480.0
    zfun = lambda x, y: (
        3.0 + 0.25 * np.sin(1.7 * x + 0.5) * np.cos(1.9 * y)
        + 0.15 * np.sin(0.9 * y + 1.0)
    )
    tex = lambda x, y: np.stack(
        [0.5 + 0.45 * np.sin(3 * x), 0.5 + 0.45 * np.cos(2 * y + 1),
         0.5 + 0.45 * np.sin(1.3 * (x + y))], -1)
    dx = (np.arange(W) - cx) / fx
    dy = ((np.arange(H) - cy) / fy)[:, None]
    dx = np.broadcast_to(dx, (H, W))
    dy = np.broadcast_to(dy, (H, W))

    seq = root / "rgbd_dataset_freiburg1_render"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb_l, dep_l, gt_l = [], [], []
    for k in range(n_frames):
        t = np.array([0.03 * k, 0.015 * k, 0.01 * k])
        s = np.full((H, W), 3.0)
        for _ in range(30):
            s = zfun(t[0] + s * dx, t[1] + s * dy) - t[2]
        ts = 100.0 + 0.033 * k
        imagefile.imwrite(
            str(seq / "rgb" / f"{ts:.6f}.png"),
            (tex(t[0] + s * dx, t[1] + s * dy) * 255).astype(np.uint8),
        )
        imagefile.imwrite(
            str(seq / "depth" / f"{ts:.6f}.png"),
            np.round(s * 5000).astype(np.uint16),
        )
        rgb_l.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep_l.append(f"{ts:.6f} depth/{ts:.6f}.png")
        gt_l.append(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} 0 0 0 1")
    (seq / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_l))
    (seq / "depth.txt").write_text("# depth\n" + "\n".join(dep_l))
    (seq / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt_l))
    return root


def main():
    args = parser.parse_args()
    device = resolve_device("cpu" if args.cpu else args.device)
    basedir = args.basedir
    if not basedir:
        basedir = render_tum_tree(
            pathlib.Path(tempfile.mkdtemp(prefix="tum_e2e_")),
            H=args.height, W=args.width,
        )
        print(f"rendered synthetic TUM tree at {basedir}")

    print(f"native C++ decoder: {native_loader.native_available()}")
    ds = TUM(str(basedir), seqlen=args.seqlen,
             height=args.height, width=args.width)
    loader = DataLoader(ds, batch_size=1, num_workers=4, prefetch=2,
                        to_device=device)
    opts = SLAMOptions(odom="gradicp", numiters=args.numiters, dsratio=2,
                       fusion=True)

    t0 = time.perf_counter()
    n_frames = 0
    for colors, depths, K, poses_gt, *_ in loader:
        B, L, H, W, _ = colors.shape
        m, poses = slam_sequence_managed(
            colors, depths, K, None, opts, L * H * W, segment_len=4
        )
        poses = close_loops_rgbd(colors, depths, K, poses, dsratio=2,
                                 min_separation=3, max_candidates=2)
        ate = ate_rmse(poses, poses_gt).cpu().numpy()
        n_frames += B * L
        print(f"window: ATE-RMSE {np.atleast_1d(ate)} m "
              f"(map points {m.num_points.cpu().numpy()})")
    dt = time.perf_counter() - t0
    print(f"IO-included throughput: {n_frames / dt:.1f} frames/s "
          f"({n_frames} frames in {dt:.2f}s, decode overlapped with compute)")


if __name__ == "__main__":
    main()
