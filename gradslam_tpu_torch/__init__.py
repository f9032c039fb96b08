"""gradslam_tpu_torch: the PyTorch / CUDA port of gradslam_tpu.

Differentiable dense RGB-D SLAM for an NVIDIA Hopper card: the same public
API and results as the JAX package, with its TPU kernel rewritten by hand
in CUDA (``csrc/``). Entry points run on ``"cuda"`` unless given
``device="cpu"``; with no card they raise instead of falling back. On the
card the frame step runs as a captured CUDA graph, the counterpart of
``jax.jit``, and a training step as one captured graph of forward and
backward (``value_and_grad``, ``GradStep``: ``jax.jit(jax.value_and_grad)``);
``disable_graphs()`` runs them op by op (``jax.disable_jit``) and
``clear_graphs()`` drops the captured steps (``jax.clear_caches``).

    >>> from gradslam_tpu_torch import RGBDImages, PointFusion
    >>> rgbdimages = RGBDImages(colors, depths, intrinsics)
    >>> pointclouds, recovered_poses = PointFusion()(rgbdimages)
"""

from . import config, datasets, geometry, metrics, odometry, ops, parallel, slam, structures, utils, viz
from .slam import ICPSLAM, GradStep, PointFusion, clear_graphs, disable_graphs, value_and_grad
from .structures import MapState, Pointclouds, RGBDImages, init_map

__version__ = "0.1.0"

__all__ = [
    "config",
    "datasets",
    "geometry",
    "metrics",
    "odometry",
    "ops",
    "parallel",
    "slam",
    "structures",
    "utils",
    "viz",
    "ICPSLAM",
    "PointFusion",
    "Pointclouds",
    "RGBDImages",
    "MapState",
    "init_map",
    "disable_graphs",
    "clear_graphs",
    "GradStep",
    "value_and_grad",
    "__version__",
]
