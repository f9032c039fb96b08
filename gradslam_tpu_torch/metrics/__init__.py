from .reconstruction import chamfer_distance, map_accuracy
from .trajectory import ate_rmse, rpe, trajectory_positions, umeyama_alignment

__all__ = [
    "ate_rmse",
    "rpe",
    "trajectory_positions",
    "umeyama_alignment",
    "chamfer_distance",
    "map_accuracy",
]
