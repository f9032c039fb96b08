"""Dataset utility functions (host-side numpy; a copy of
gradslam_tpu.datasets.datautils).

Parity surface with the reference's datautils
(reference: gradslam/datasets/datautils.py).
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = [
    "normalize_image",
    "channels_first",
    "scale_intrinsics",
    "pointquaternion_to_homogeneous",
    "poses_to_transforms",
    "create_label_image",
]


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    """Scales [0, 255] images to [0, 1] floats (reference datautils.py:19)."""
    return np.asarray(rgb).astype(np.float32) / 255.0


def channels_first(rgb: np.ndarray) -> np.ndarray:
    """Moves the trailing channel dim in front of the spatial dims
    (reference datautils.py:40): (..., H, W, C) -> (..., C, H, W)."""
    rgb = np.asarray(rgb)
    if rgb.ndim < 3:
        raise ValueError(f"rgb must have at least 3 dims, got {rgb.ndim}")
    ordering = list(range(rgb.ndim - 3)) + [
        rgb.ndim - 1,
        rgb.ndim - 3,
        rgb.ndim - 2,
    ]
    return np.transpose(rgb, ordering)


def scale_intrinsics(
    intrinsics: np.ndarray,
    h_ratio: Union[float, int],
    w_ratio: Union[float, int],
) -> np.ndarray:
    """Scales fx/cx by ``w_ratio`` and fy/cy by ``h_ratio``
    (reference datautils.py:73). Accepts (..., 3, 3) or (..., 4, 4)."""
    intrinsics = np.asarray(intrinsics).copy().astype(np.float32)
    if intrinsics.shape[-2:] not in ((3, 3), (4, 4)):
        raise ValueError(
            f"intrinsics must be (..., 3, 3) or (..., 4, 4), got {intrinsics.shape}"
        )
    intrinsics[..., 0, 0] *= w_ratio  # fx
    intrinsics[..., 1, 1] *= h_ratio  # fy
    intrinsics[..., 0, 2] *= w_ratio  # cx
    intrinsics[..., 1, 2] *= h_ratio  # cy
    return intrinsics


def pointquaternion_to_homogeneous(
    pointquaternions: np.ndarray, eps: float = 1e-12
) -> np.ndarray:
    """Converts (..., 7) ``[tx, ty, tz, qx, qy, qz, qw]`` rows to
    (..., 4, 4) homogeneous transforms (reference datautils.py:120)."""
    pq = np.asarray(pointquaternions, dtype=np.float32)
    if pq.shape[-1] != 7:
        raise ValueError(
            f"pointquaternions must be (..., 7), got {pq.shape}"
        )
    t = pq[..., :3]
    q = pq[..., 3:]
    # eps-guarded normalization
    norm_sq = np.sum(q**2, axis=-1, keepdims=True)
    q = q / np.sqrt(np.maximum(norm_sq, eps))
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    out = np.zeros(pq.shape[:-1] + (4, 4), dtype=np.float32)
    out[..., 0, 0] = 1 - 2 * (y * y + z * z)
    out[..., 0, 1] = 2 * (x * y - w * z)
    out[..., 0, 2] = 2 * (x * z + w * y)
    out[..., 1, 0] = 2 * (x * y + w * z)
    out[..., 1, 1] = 1 - 2 * (x * x + z * z)
    out[..., 1, 2] = 2 * (y * z - w * x)
    out[..., 2, 0] = 2 * (x * z - w * y)
    out[..., 2, 1] = 2 * (y * z + w * x)
    out[..., 2, 2] = 1 - 2 * (x * x + y * y)
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def poses_to_transforms(poses: np.ndarray) -> np.ndarray:
    """Converts absolute poses to frame-to-frame relative transforms
    (reference datautils.py:218): output[0] = poses[0];
    output[i] = poses[i-1]^-1 @ poses[i]."""
    poses = np.asarray(poses)
    out = poses.copy()
    for i in range(1, poses.shape[0]):
        out[i] = np.linalg.inv(poses[i - 1]) @ poses[i]
    return out


def create_label_image(
    prediction: np.ndarray, color_palette: dict
) -> np.ndarray:
    """Maps a (H, W) label image to an RGB image via a palette dict
    (reference datautils.py:242)."""
    label_image = np.zeros(prediction.shape + (3,), dtype=np.uint8)
    for idx, color in color_palette.items():
        label_image[prediction == idx] = color
    return label_image
