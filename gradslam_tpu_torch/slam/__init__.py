from .icpslam import (
    ICPSLAM,
    SLAMOptions,
    SLAMState,
    slam_init_state,
    slam_sequence,
    slam_state_from_numpy,
    slam_state_to_numpy,
    slam_step,
    slam_step_state,
)
from .pointfusion import PointFusion
from .fusionutils import (
    aggregate_map_dense,
    are_normals_similar,
    are_points_close,
    fusion_update_compact,
    get_alpha,
)

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "SLAMOptions",
    "SLAMState",
    "slam_step",
    "slam_init_state",
    "slam_step_state",
    "slam_sequence",
    "slam_state_from_numpy",
    "slam_state_to_numpy",
    "get_alpha",
    "are_points_close",
    "are_normals_similar",
    "fusion_update_compact",
    "aggregate_map_dense",
]
