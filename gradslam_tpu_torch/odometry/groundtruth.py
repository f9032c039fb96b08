"""Ground-truth odometry provider (PyTorch port of
gradslam_tpu.odometry.groundtruth)."""

from __future__ import annotations

from ..geometry import relative_transformation
from .base import OdometryProvider

__all__ = ["GroundTruthOdometryProvider"]


class GroundTruthOdometryProvider(OdometryProvider):
    """The relative pose ``T1^-1 @ T2`` of two frames' stored poses."""

    def provide(self, rgbdimages1, rgbdimages2):
        """Relative transforms between two sequence-length-1 batches.

        Args:
            rgbdimages1: previous frames (B, 1), with poses.
            rgbdimages2: live frames (B, 1), with poses.

        Returns:
            (B, 1, 4, 4) transforms.
        """
        if rgbdimages1.shape[1] != 1 or rgbdimages2.shape[1] != 1:
            raise ValueError(
                "expected sequence length 1 for both frame batches, got "
                f"{rgbdimages1.shape[1]} and {rgbdimages2.shape[1]}"
            )
        if not (rgbdimages1.has_poses and rgbdimages2.has_poses):
            raise ValueError("both frame batches must have poses")
        t1, t2 = rgbdimages1.poses[:, 0], rgbdimages2.poses[:, 0]
        return relative_transformation(t1, t2, orthogonal_rotations=False)[:, None]
