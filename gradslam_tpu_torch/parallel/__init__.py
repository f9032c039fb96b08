from .pose_refine import PoseGraph, ba_refine, pose_graph_refine, pose_graph_residuals
from .sharded import DepthCalibParams, depth_calib_from_numpy, slam_loss

__all__ = [
    "PoseGraph",
    "pose_graph_residuals",
    "pose_graph_refine",
    "ba_refine",
    "DepthCalibParams",
    "slam_loss",
    "depth_calib_from_numpy",
]
