from .icp_system import icp_system_kernel
from .knn import KnnTargets, knn, knn_kernel, knn_reference, prepare_targets
from .masking import (
    append_slots,
    append_slots_reference,
    compact_masked,
    compact_masked_reference,
    mask_scan_kernel,
)
from .voxel import voxel_merge, voxel_merge_rows
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
    "compact_masked_reference",
    "append_slots",
    "append_slots_reference",
    "mask_scan_kernel",
    "icp_system_kernel",
    "pixel_winner",
    "pixel_winner_reference",
    "winner_kernel",
    "winner_keys",
    "winner_order_keys",
    "voxel_merge",
    "voxel_merge_rows",
]
