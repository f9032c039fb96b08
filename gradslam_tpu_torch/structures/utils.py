"""Structure conversion helpers (PyTorch port of
gradslam_tpu.structures.utils)."""

from __future__ import annotations

import torch

from .pointclouds import Pointclouds
from .rgbdimages import RGBDImages

__all__ = ["pointclouds_from_rgbdimages"]


def pointclouds_from_rgbdimages(
    rgbdimages: RGBDImages,
    *,
    global_coordinates: bool = True,
    filter_missing_depths: bool = True,
) -> Pointclouds:
    """A sequence-length-1 :class:`RGBDImages` batch as :class:`Pointclouds`:
    the global (or camera-frame) vertex and normal maps with the colors.

    With ``filter_missing_depths`` only the valid-depth pixels count (see
    :func:`valid_points_first`).
    """
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(f"expected RGBDImages, got {type(rgbdimages).__name__}")
    if rgbdimages.shape[1] != 1:
        raise ValueError(f"expected sequence length 1, got {rgbdimages.shape[1]}")
    rgbd = rgbdimages.to_channels_last()
    B, _, H, W = rgbd.shape
    HW = H * W
    if global_coordinates:
        vmap, nmap = rgbd.global_vertex_map, rgbd.global_normal_map
    else:
        vmap, nmap = rgbd.vertex_map, rgbd.normal_map
    pts, nrm, col = (x.reshape(B, HW, 3) for x in (vmap, nmap, rgbd.rgb_image))
    if not filter_missing_depths:
        return Pointclouds(points=pts, normals=nrm, colors=col)
    return valid_points_first(pts, nrm, col, rgbd.valid_depth_mask.reshape(B, HW))


def valid_points_first(points, normals, colors, valid) -> Pointclouds:
    """(B, N, 3) points, normals and colors as :class:`Pointclouds` of the
    rows where the (B, N) ``valid`` holds: those rows first, in order, then
    zero padding."""
    B, N, _ = points.shape
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    counts = valid.sum(dim=1, dtype=torch.int32)
    keep = (torch.arange(N, device=valid.device)[None, :] < counts[:, None])[..., None].to(points.dtype)
    take = lambda x: torch.gather(x, 1, order[..., None].expand(B, N, 3)) * keep
    return Pointclouds(points=take(points), normals=take(normals), colors=take(colors), num_points=counts)
