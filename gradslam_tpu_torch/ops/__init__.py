from .knn import KnnTargets, knn, knn_kernel, knn_reference, prepare_targets
from .masking import compact_masked

__all__ = [
    "knn",
    "knn_reference",
    "knn_kernel",
    "prepare_targets",
    "KnnTargets",
    "compact_masked",
]
