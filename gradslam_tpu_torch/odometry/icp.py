"""Point-to-plane ICP odometry provider (PyTorch port of
gradslam_tpu.odometry.icp): one batched solve, its associations from the
KNN kernel on the card."""

from __future__ import annotations

from typing import Optional

from .base import OdometryProvider
from .icputils import point_to_plane_ICP

__all__ = ["ICPOdometryProvider"]


def _check_clouds(maps_pointclouds, frames_pointclouds) -> None:
    """The providers' input checks: the map has normals, the batches match."""
    if maps_pointclouds.normals_padded is None:
        raise ValueError("maps_pointclouds must have normals")
    if len(maps_pointclouds) != len(frames_pointclouds):
        raise ValueError(f"batch size mismatch: {len(maps_pointclouds)} vs {len(frames_pointclouds)}")


class ICPOdometryProvider(OdometryProvider):
    """ICP odometry with the classic LM accept/reject trust region.

    Args:
        numiters: solver iterations. Default 20.
        damp: initial LM damping. Default 1e-8.
        dist_thresh: optional squared-distance association gate.
    """

    def __init__(self, numiters: int = 20, damp: float = 1e-8, dist_thresh: Optional[float] = None):
        self.numiters = numiters
        self.damp = damp
        self.dist_thresh = dist_thresh

    def provide(self, maps_pointclouds, frames_pointclouds):
        """Relative transforms that warp the frame clouds onto the map
        clouds (targets, with normals).

        Returns:
            (B, 1, 4, 4) transforms.
        """
        _check_clouds(maps_pointclouds, frames_pointclouds)
        src = frames_pointclouds.points_padded
        transform = point_to_plane_ICP(
            src, maps_pointclouds.points_padded, maps_pointclouds.normals_padded, None,
            numiters=self.numiters, damp=self.damp, dist_thresh=self.dist_thresh,
            src_valid=frames_pointclouds.nonpad_mask.to(src.dtype),
            tgt_valid=maps_pointclouds.nonpad_mask,
        )
        return transform[:, None]
