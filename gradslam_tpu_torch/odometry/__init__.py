from .icputils import (
    FramePoints,
    frame_points_from_maps,
    gauss_newton_solve,
    huber_weights,
    point_to_plane_ICP,
    point_to_plane_gradICP,
    solve_linear_system,
)

__all__ = [
    "FramePoints",
    "solve_linear_system",
    "gauss_newton_solve",
    "huber_weights",
    "point_to_plane_ICP",
    "point_to_plane_gradICP",
    "frame_points_from_maps",
]
