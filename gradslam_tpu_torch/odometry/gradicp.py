"""GradICP odometry provider (PyTorch port of
gradslam_tpu.odometry.gradicp): the smooth, differentiable LM, one batched
solve, its associations from the KNN kernel on the card."""

from __future__ import annotations

from typing import Optional

from .base import OdometryProvider
from .icp import _check_clouds
from .icputils import point_to_plane_gradICP

__all__ = ["GradICPOdometryProvider"]


class GradICPOdometryProvider(OdometryProvider):
    """GradICP odometry with the gradLM soft trust region.

    Args:
        numiters: solver iterations. Default 20.
        damp: initial damping. Default 1e-8.
        dist_thresh: optional squared-distance association gate.
        lambda_max: max damping gain (lambda_min = 1/lambda_max). Default 2.
        B: gradLM damping-gate falloff. Default 1.
        B2: gradLM step-gate falloff. Default 1.
        nu: gradLM step-gate exponent. Default 200.
    """

    def __init__(
        self,
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
    ):
        self.numiters = numiters
        self.damp = damp
        self.dist_thresh = dist_thresh
        self.lambda_max = lambda_max
        self.B = B
        self.B2 = B2
        self.nu = nu

    def provide(self, maps_pointclouds, frames_pointclouds):
        """Relative transforms that warp the frame clouds onto the map
        clouds (targets, with normals).

        Returns:
            (B, 1, 4, 4) transforms.
        """
        _check_clouds(maps_pointclouds, frames_pointclouds)
        src = frames_pointclouds.points_padded
        transform = point_to_plane_gradICP(
            src, maps_pointclouds.points_padded, maps_pointclouds.normals_padded, None,
            numiters=self.numiters, damp=self.damp, dist_thresh=self.dist_thresh,
            lambda_max=self.lambda_max, B=self.B, B2=self.B2, nu=self.nu,
            src_valid=frames_pointclouds.nonpad_mask.to(src.dtype),
            tgt_valid=maps_pointclouds.nonpad_mask,
        )
        return transform[:, None]
