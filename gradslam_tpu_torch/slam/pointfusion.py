"""PointFusion SLAM (Keller et al. 2013): an ICPSLAM whose mapping step is
the confidence-weighted fusion update (PyTorch port of
gradslam_tpu.slam.pointfusion)."""

from __future__ import annotations

import math
from typing import Optional

from .icpslam import ICPSLAM

__all__ = ["PointFusion"]


class PointFusion(ICPSLAM):
    """PointFusion pipeline.

    Example:
        >>> slam = PointFusion(odom='gradicp')
        >>> pointclouds, poses = slam(rgbdimages)

    Args:
        odom: 'gt', 'icp' or 'gradicp'.
        dist_th: fusion distance threshold (default 0.05 m).
        angle_th: fusion normal angle threshold in degrees (default 20),
            used as the dot-product threshold ``cos(angle_th)``.
        sigma: confidence Gaussian width (default 0.6).
        Remaining args as :class:`ICPSLAM`, ``device`` included.
    """

    _fusion = True

    def __init__(
        self,
        *,
        odom: str = "gradicp",
        dist_th: float = 0.05,
        angle_th: Optional[float] = 20.0,
        dot_th: Optional[float] = None,
        sigma: float = 0.6,
        **kwargs,
    ):
        if dot_th is None:
            if not 0 <= angle_th <= 90:
                raise ValueError(f"angle_th must be in [0, 90] degrees, got {angle_th}")
            dot_th = math.cos(math.radians(angle_th))
        if dist_th < 0:
            raise ValueError(f"dist_th must be non-negative, got {dist_th}")
        super().__init__(odom=odom, dist_th=dist_th, dot_th=dot_th, sigma=sigma, **kwargs)
