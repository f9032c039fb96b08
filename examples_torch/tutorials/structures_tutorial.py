"""Tutorial: RGBDImages and Pointclouds structures, on the PyTorch / CUDA
port.

Mirrors the reference's structures tutorial notebooks as a runnable
script (the twin of ``examples/tutorials/structures_tutorial.py``). Runs on
``--device`` (default ``cuda``).
"""

import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import argparse

import numpy as np
import torch

from gradslam_tpu_torch import Pointclouds, RGBDImages
from gradslam_tpu_torch.geometry import se3_exp
from gradslam_tpu_torch.structures import pointclouds_from_rgbdimages
from gradslam_tpu_torch.utils import resolve_device

DATA = pathlib.Path(__file__).parents[2] / "tests" / "data" / "msrd_b2s3"

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")


def main():
    device = resolve_device(parser.parse_args().device)
    # --- RGBDImages ----------------------------------------------------
    colors = np.load(DATA / "colors.npy")
    depths = np.load(DATA / "depths.npy")
    intrinsics = np.load(DATA / "intrinsics.npy")
    poses = np.load(DATA / "poses.npy")
    rgbd = RGBDImages(colors, depths, intrinsics, poses, device=device)
    print("shape (B, L, H, W):", rgbd.shape)

    # lazy derived maps
    print("valid pixels:", int(rgbd.valid_depth_mask.sum()))
    print("vertex map:", rgbd.vertex_map.shape)
    print("global normal map:", rgbd.global_normal_map.shape)

    # (batch, time) indexing keeps dims
    frame = rgbd[0, 1]
    print("one frame:", frame.shape)

    # channels-first view for torch-style consumers
    print("channels-first rgb:", rgbd.to_channels_first().rgb_image.shape)

    # --- Pointclouds ---------------------------------------------------
    # from ragged per-cloud tensors
    rng = np.random.RandomState(0)
    on = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)
    pc = Pointclouds(
        points=[on(rng.randn(100, 3)), on(rng.randn(60, 3))],
        colors=[on(rng.rand(100, 3)), on(rng.rand(60, 3))],
    )
    print("pointclouds:", pc)

    # arithmetic and rigid-transform ops (functional: return new objects)
    moved = (pc + torch.tensor([1.0, 0, 0], device=device)) * 2.0
    T = se3_exp(torch.tensor([0.1, 0, 0, 0, 0, 0.3], device=device))
    transformed = pc.transform(T)
    print("transformed first point:", transformed.points_padded[0, 0].cpu().numpy())

    # from an RGB-D frame (world-frame cloud, invalid depths filtered)
    frame_pc = pointclouds_from_rgbdimages(rgbd[:, 0])
    print(
        "frame cloud sizes:",
        frame_pc.num_points_per_pointcloud.cpu().numpy(),
    )
    return moved


if __name__ == "__main__":
    main()
