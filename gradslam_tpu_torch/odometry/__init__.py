from .base import OdometryProvider
from .groundtruth import GroundTruthOdometryProvider
from .icp import ICPOdometryProvider
from .gradicp import GradICPOdometryProvider
from .icputils import (
    FramePoints,
    downsample_pointclouds,
    downsample_rgbdimages,
    frame_points_from_maps,
    gauss_newton_solve,
    gauss_newton_solve_projective,
    huber_weights,
    point_to_plane_ICP,
    point_to_plane_ICP_projective,
    point_to_plane_gradICP,
    point_to_plane_gradICP_projective,
    solve_linear_system,
)

__all__ = [
    "OdometryProvider",
    "GroundTruthOdometryProvider",
    "ICPOdometryProvider",
    "GradICPOdometryProvider",
    "FramePoints",
    "solve_linear_system",
    "gauss_newton_solve",
    "gauss_newton_solve_projective",
    "huber_weights",
    "point_to_plane_ICP",
    "point_to_plane_gradICP",
    "point_to_plane_ICP_projective",
    "point_to_plane_gradICP_projective",
    "downsample_pointclouds",
    "downsample_rgbdimages",
    "frame_points_from_maps",
]
