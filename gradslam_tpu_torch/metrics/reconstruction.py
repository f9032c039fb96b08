"""Reconstruction quality metrics, chamfer distance and map accuracy
(PyTorch port of gradslam_tpu.metrics.reconstruction).

Both run on :func:`ops.knn.knn`: the Hopper kernel for CUDA tensors, the
plain version for CPU ones. The nearest distances are detached, as the JAX
package's are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.knn import knn

__all__ = ["chamfer_distance", "map_accuracy"]


def _masked_mean(x, valid):
    if valid is None:
        return x.mean(dim=1)
    w = valid.to(x.dtype)
    return (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1)


def chamfer_distance(
    points_a: torch.Tensor,
    points_b: torch.Tensor,
    valid_a: Optional[torch.Tensor] = None,
    valid_b: Optional[torch.Tensor] = None,
    squared: bool = True,
) -> torch.Tensor:
    """Symmetric chamfer distance between two batched point sets.

    ``CD = mean_a min_b |a-b|^2 + mean_b min_a |b-a|^2`` (the classic
    reconstruction-vs-ground-truth metric; ``squared=False`` for root
    distances).

    Args:
        points_a / points_b: (B, N, 3) / (B, M, 3).
        valid_a / valid_b: optional (B, N) / (B, M) masks.

    Returns:
        (B,) chamfer distances.
    """
    d_ab, _ = knn(points_a, points_b, valid_b)
    d_ba, _ = knn(points_b, points_a, valid_a)
    if not squared:
        d_ab = torch.sqrt(torch.clamp(d_ab, min=0))
        d_ba = torch.sqrt(torch.clamp(d_ba, min=0))
    return _masked_mean(d_ab, valid_a) + _masked_mean(d_ba, valid_b)


def map_accuracy(
    map_points: torch.Tensor,
    gt_points: torch.Tensor,
    map_valid: Optional[torch.Tensor] = None,
    gt_valid: Optional[torch.Tensor] = None,
    threshold: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accuracy and completeness of a reconstructed map against ground truth.

    Accuracy: the fraction of map points within ``threshold`` of the ground
    truth. Completeness: the fraction of ground-truth points within
    ``threshold`` of the map.

    Returns:
        (accuracy (B,), completeness (B,)), float32.
    """
    d_mg, _ = knn(map_points, gt_points, gt_valid)
    d_gm, _ = knn(gt_points, map_points, map_valid)
    th_sq = threshold * threshold
    return (
        _masked_mean((d_mg < th_sq).to(torch.float32), map_valid),
        _masked_mean((d_gm < th_sq).to(torch.float32), gt_valid),
    )
