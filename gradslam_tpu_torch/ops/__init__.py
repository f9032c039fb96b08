from .knn import KnnTargets, knn, knn_kernel, knn_reference, prepare_targets
from .masking import compact_masked
from .winner import (
    pixel_winner,
    pixel_winner_reference,
    winner_keys,
    winner_kernel,
    winner_order_keys,
)

__all__ = [
    "knn",
    "knn_reference",
    "knn_kernel",
    "prepare_targets",
    "KnnTargets",
    "compact_masked",
    "pixel_winner",
    "pixel_winner_reference",
    "winner_kernel",
    "winner_keys",
    "winner_order_keys",
]
