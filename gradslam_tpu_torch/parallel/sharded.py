"""Differentiable SLAM training on one device (PyTorch port of the
single-device part of gradslam_tpu.parallel.sharded).

The end-to-end stretch goal: optimize depth-calibration parameters by
backpropagating a trajectory loss through the whole SLAM run (odometry and
fusion). Neither kernel of the forward has a backward: the KNN outputs are
detached and the fusion winners are integers, so autograd differentiates
the gathers, solves and merges around them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..slam.icpslam import SLAMOptions, slam_sequence
from ..utils.device import resolve_device

__all__ = ["DepthCalibParams", "slam_loss", "depth_calib_from_numpy"]


class DepthCalibParams(nn.Module):
    """Differentiable sensor-calibration parameters: the observed depth
    becomes ``depth * scale + bias`` where it is valid (``depth > 0``).

    Args:
        scale, bias: initial values (default 1 and 0, the JAX package's
            ``DepthCalibParams.init()``), float32 parameters.
        device: default ``"cuda"``.
    """

    def __init__(self, scale: float = 1.0, bias: float = 0.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.tensor(bias, dtype=torch.float32, device=dev))

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        return depth * self.scale + self.bias * (depth > 0)


def slam_loss(
    params: DepthCalibParams,
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    gt_poses: torch.Tensor,
    opts: SLAMOptions,
    capacity: int,
) -> torch.Tensor:
    """Trajectory loss after applying depth calibration: the mean squared
    position error of the recovered (B, L) trajectory against ``gt_poses``,
    differentiable end to end through odometry and fusion."""
    _, poses = slam_sequence(rgb_seq, params(depth_seq), intrinsics, None, opts, capacity)
    return ((poses[..., :3, 3] - gt_poses[..., :3, 3]) ** 2).mean()


def depth_calib_from_numpy(scale, bias, device=None) -> DepthCalibParams:
    """A :class:`DepthCalibParams` from the JAX package's
    ``DepthCalibParams`` fields as numpy scalars."""
    return DepthCalibParams(
        float(np.float32(np.asarray(scale))), float(np.float32(np.asarray(bias))), device=device
    )
