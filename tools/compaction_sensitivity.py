"""How far a compacted run on the card stays with the same run on the CPU.

    python tools/compaction_sensitivity.py [--voxels 0.002 0.005 0.01 0.02]
                                           [--eps 1e-7 1e-5]

``chip_smoke.py`` phase 17's setup: ``slam_sequence_compacted`` on the
golden clip (B=2, L=6, ``PointFusion()`` defaults, an arena of 2*H*W rows
voxel-merged every 2 frames). For each voxel size, runs it on the card and
on the CPU and prints, per compaction, the live rows before and after on
each device, then the largest pose difference and the card's gradient of
the pose loss with respect to the depth maps against the CPU's (relative
to the CPU's largest value). Then, on the CPU alone, the same run with the
depth maps scaled by ``1 + eps``: a run whose result moves under such a
perturbation takes a decision at a threshold (a point's cell, a fusion
gate), and the card's last-bit differences can take it the other way.
Without a card, only the CPU part runs.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(colors, depths, K, dev, voxel, eps=0.0):
    """(live rows before and after each compaction, poses, depth gradient)."""
    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.slam import lifecycle, slam_sequence_compacted

    H, W = colors.shape[2:4]
    counts = []
    real = lifecycle.compact_slam_state

    def recording(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        counts.append((state.map_state.num_points.tolist(), out.map_state.num_points.tolist()))
        return out

    rgb, depth, Kt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K))
    depth = (depth * (1.0 + eps)).requires_grad_(True)
    lifecycle.compact_slam_state = recording
    try:
        _, poses, _ = slam_sequence_compacted(rgb, depth, Kt, None, PointFusion(device=dev).opts, 2 * H * W,
                                              segment_len=2, voxel_size=voxel)
    finally:
        lifecycle.compact_slam_state = real
    (poses[..., :3, 3] ** 2).sum().backward()
    return counts, poses.detach().cpu(), depth.grad.cpu()


def _compare(name, a, b):
    (ca, pa, ga), (cb, pb, gb) = a, b
    rel = float((ga - gb).abs().max() / gb.abs().max())
    print(f"{name}: live before/after each compaction {ca} vs {cb}; max |pose diff| "
          f"{float((pa - pb).abs().max())}; max |grad diff| / max |grad| {rel}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--voxels", type=float, nargs="+", default=[0.002, 0.005, 0.0075, 0.01, 2.0**-6, 0.02])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-5])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    colors, depths, K = chip_smoke._golden_clip(6)
    cpu = torch.device("cpu")
    card = torch.cuda.is_available()
    if card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        chip_smoke._build_kernels()
    for voxel in args.voxels:
        ref = _run(colors, depths, K, cpu, voxel)
        if card:
            _compare(f"voxel {voxel} card vs cpu", _run(colors, depths, K, torch.device("cuda", 0), voxel), ref)
        for eps in args.eps:
            _compare(f"voxel {voxel} cpu, depth x (1 + {eps}) vs cpu", _run(colors, depths, K, cpu, voxel, eps), ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
