"""gradslam_tpu_torch: the PyTorch / CUDA port of gradslam_tpu.

Differentiable dense RGB-D SLAM for an NVIDIA Hopper card: the same public
API and results as the JAX package, with its TPU kernel rewritten by hand
in CUDA (``csrc/``). Entry points run on ``"cuda"`` unless given
``device="cpu"``; with no card they raise instead of falling back.

    >>> from gradslam_tpu_torch import RGBDImages, PointFusion
    >>> rgbdimages = RGBDImages(colors, depths, intrinsics)
    >>> pointclouds, recovered_poses = PointFusion()(rgbdimages)
"""

from . import geometry, metrics, odometry, ops, parallel, slam, structures
from .slam import ICPSLAM, PointFusion
from .structures import MapState, Pointclouds, RGBDImages, init_map

__version__ = "0.1.0"

__all__ = [
    "geometry",
    "metrics",
    "odometry",
    "ops",
    "parallel",
    "slam",
    "structures",
    "ICPSLAM",
    "PointFusion",
    "Pointclouds",
    "RGBDImages",
    "MapState",
    "init_map",
    "__version__",
]
