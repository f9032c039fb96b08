from .rgbdimages import (
    RGBDImages,
    compute_global_normal_map,
    compute_global_vertex_map,
    compute_normal_map,
    compute_vertex_map,
    pixel_rays,
    valid_depth_mask,
)
from .pointclouds import Pointclouds
from .maparena import (
    MapState,
    append_rows_to_map,
    append_to_map,
    compact_map,
    init_map,
    map_mask,
    map_state_from_numpy,
    map_state_to_numpy,
    map_to_pointclouds,
    pack_rows,
)
from .structutils import list_to_padded, padded_to_list
from .utils import pointclouds_from_rgbdimages

__all__ = [
    "RGBDImages",
    "Pointclouds",
    "MapState",
    "init_map",
    "map_mask",
    "pack_rows",
    "append_rows_to_map",
    "append_to_map",
    "compact_map",
    "map_to_pointclouds",
    "pointclouds_from_rgbdimages",
    "map_state_from_numpy",
    "map_state_to_numpy",
    "list_to_padded",
    "padded_to_list",
    "compute_vertex_map",
    "compute_global_vertex_map",
    "compute_normal_map",
    "compute_global_normal_map",
    "pixel_rays",
    "valid_depth_mask",
]
