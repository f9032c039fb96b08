from .sharded import DepthCalibParams, depth_calib_from_numpy, slam_loss

__all__ = ["DepthCalibParams", "slam_loss", "depth_calib_from_numpy"]
