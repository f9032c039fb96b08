from .projutils import (
    homogenize_points,
    inverse_intrinsics,
    project_points,
    project_points_to_pixels,
    unhomogenize_points,
    unproject_points,
)
from .geometryutils import (
    compose_transformations,
    create_meshgrid,
    inverse_transformation,
    normalize_quaternion,
    quaternion_to_axisangle,
    quaternion_to_rotation_matrix,
    relative_transformation,
    transform_normals,
    transform_pointcloud,
)
from .se3 import rt_matrix, se3_exp, se3_hat, se3_log, so3_exp, so3_hat

__all__ = [
    "project_points_to_pixels",
    "homogenize_points",
    "unhomogenize_points",
    "project_points",
    "unproject_points",
    "inverse_intrinsics",
    "create_meshgrid",
    "normalize_quaternion",
    "quaternion_to_axisangle",
    "quaternion_to_rotation_matrix",
    "inverse_transformation",
    "compose_transformations",
    "relative_transformation",
    "transform_pointcloud",
    "transform_normals",
    "rt_matrix",
    "so3_hat",
    "se3_hat",
    "so3_exp",
    "se3_exp",
    "se3_log",
]
