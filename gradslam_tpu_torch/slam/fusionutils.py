"""PointFusion association and fusion (PyTorch port of the exact path of
gradslam_tpu.slam.fusionutils).

Association state is dense and of fixed size: the map points active in the
live frame are compacted into an ``active_capacity`` buffer, one winner per
pixel is picked by a multi-key sort (max ccount, then min ray distance,
then min arena slot, as the reference's ``torch.unique`` row sort does),
winners get a confidence-weighted merge written back with one row scatter,
and every other valid pixel is appended to the arena.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..geometry import project_points_to_pixels
from ..ops.masking import compact_masked
from ..structures.maparena import (
    MapState,
    append_rows_to_map,
    append_to_map,
    map_mask,
    scatter_rows,
)

__all__ = [
    "get_alpha",
    "are_points_close",
    "are_normals_similar",
    "fusion_update_compact",
    "aggregate_map_dense",
    "winner_order",
]


def get_alpha(
    points: torch.Tensor,
    sigma: Union[float, torch.Tensor],
    dim: int = -1,
    keepdim: bool = False,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Sample confidence ``exp(-|p|^2 / (2 sigma^2))`` clamped to
    ``[eps, 1.01]``, from camera-frame positions (Keller et al. 2013)."""
    alpha = torch.exp(-(points**2).sum(dim, keepdim=keepdim) / (2 * sigma**2))
    return torch.clamp(alpha, eps, 1.01)


def are_points_close(t1, t2, dist_th, dim: int = -1):
    """Per-element Euclidean distance threshold."""
    d = t1 - t2
    return torch.sqrt((d * d).sum(dim)) < dist_th


def are_normals_similar(t1, t2, dot_th, dim: int = -1):
    """Per-element dot-product threshold."""
    return (t1 * t2).sum(dim) > dot_th


def _project_points_to_frame(points, live, pose, intrinsics, H, W):
    """(B, N, 3) world points -> pixel rows, cols and in-frame mask."""
    return project_points_to_pixels(points, live, pose, intrinsics, H, W)


def _ordered_int(x: torch.Tensor) -> torch.Tensor:
    """Maps float32 to int64 keys in the same order (-0.0 equal to 0.0)."""
    bits = (x + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def winner_order(pix: torch.Tensor, ccount: torch.Tensor, ray: torch.Tensor, slot: torch.Tensor):
    """Permutation sorting rows by ``(pix, -ccount, ray, slot)`` ascending.

    The JAX package does this with one 4-key ``lax.sort``. Here the keys are
    packed into two int64 words, ``(pix, -ccount)`` and ``(ray, slot)``,
    and two stable sorts run from the last word to the first, which gives
    the same lexicographic order.

    Args:
        pix: (B, A) int32 pixel keys (< 2^31); ccount, ray: (B, A) float32
            (``ray >= 0``); slot: (B, A) int32 arena slots (>= 0).
    """
    hi = (pix.to(torch.int64) << 32) | (_ordered_int(-ccount) + 2**31)
    lo = (_ordered_int(ray) << 32) | slot.to(torch.int64)
    order = torch.sort(lo, dim=1, stable=True).indices
    return torch.gather(order, 1, torch.sort(torch.gather(hi, 1, order), dim=1, stable=True).indices)


def fusion_update_compact(
    map_state: MapState,
    frame_vertex_global: torch.Tensor,
    frame_normal_global: torch.Tensor,
    frame_vertex_local: torch.Tensor,
    rgb_image: torch.Tensor,
    valid_depth: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    dist_th: float,
    dot_th: float,
    sigma: float,
    active_capacity: int,
    block_size: Optional[int] = None,
    visible_capacity: Optional[int] = None,
    return_active: bool = False,
    frame_labels: Optional[torch.Tensor] = None,
    merge_window: Optional[int] = None,
    assoc_window: int = -1,
    dense_model_rows: bool = False,
    window_merge: str = "dense",
    need_active_set: bool = True,
):
    """One PointFusion update of the arena with active-set compaction.

    Args:
        map_state: the arena.
        frame_vertex_global / frame_normal_global / frame_vertex_local /
            rgb_image: (B, H, W, 3) maps of the live frame.
        valid_depth: (B, H, W) bool.
        pose: (B, 4, 4) live pose; intrinsics: (B, 1, 4, 4).
        dist_th / dot_th: association gates; sigma: confidence width.
        active_capacity: A, the active-set buffer. Past A active rows, the
            highest slots are left out of association for this frame.
        merge_window: accepted and ignored: the JAX package's window is a
            TPU layout form of the same row scatter, bitwise identical.
        block_size, visible_capacity, frame_labels, assoc_window > 0,
        dense_model_rows, window_merge, need_active_set: the spatial-block,
            semantic-label, prefix-window and projective-odometry paths,
            not ported yet; a value that selects one raises.

    Returns:
        The new :class:`MapState`; with ``return_active`` also
        ``(arena_slot (B, A) int32, avalid (B, A) bool, model_img (B, H*W)
        int32)``: the next frame's odometry candidates and the arena slot
        fused at each pixel (CAP where none).
    """
    if block_size is not None or visible_capacity is not None:
        raise NotImplementedError("fusion block gating waits for ROADMAP A8")
    if frame_labels is not None:
        raise NotImplementedError("semantic label fusion waits for ROADMAP A8")
    if assoc_window is not None and assoc_window > 0:
        raise NotImplementedError("assoc_window waits for ROADMAP A8")
    if dense_model_rows:
        raise NotImplementedError("dense model rows (projective odometry) wait for ROADMAP A8")
    del merge_window, window_merge, need_active_set
    B, H, W, _ = frame_vertex_global.shape
    CAP = map_state.capacity
    HW = H * W
    A = active_capacity
    dev = map_state.data.device

    # packed frame attributes: gv(3) gn(3) rgb(3) alpha(1) -> one gather
    alpha_img = get_alpha(frame_vertex_local, sigma, keepdim=True)
    frame_attr = torch.cat(
        [frame_vertex_global, frame_normal_global, rgb_image, alpha_img], dim=-1
    ).reshape(B, HW, 10)

    def take(x, idx):
        return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))

    # ---- association: active set, gates, one winner per pixel ----------
    _, _, active = _project_points_to_frame(
        map_state.points, map_mask(map_state), pose, intrinsics, H, W
    )
    arena_slot, avalid = compact_masked(active, A)  # (B, A)
    ma = take(map_state.data, arena_slot)  # (B, A, 12)
    mp = ma[..., 0:3]
    ha, wa, _ = _project_points_to_frame(mp, torch.ones_like(avalid), pose, intrinsics, H, W)
    pixa = ha * W + wa
    mn, mcc = ma[..., 3:6], ma[..., 9]
    fa = take(frame_attr, pixa)
    fp, fn = fa[..., 0:3], fa[..., 3:6]
    gated = avalid & are_points_close(fp, mp, dist_th) & are_normals_similar(fn, mn, dot_th)

    pix_seg = torch.where(gated, pixa, HW)
    d = mp - fp
    ray = (d**2).sum(-1)
    order = winner_order(pix_seg, mcc, ray, arena_slot)
    pix_sorted = torch.gather(pix_seg, 1, order)
    slot_sorted = torch.gather(arena_slot, 1, order)
    first = torch.ones_like(pix_sorted, dtype=torch.bool)
    first[:, 1:] = pix_sorted[:, 1:] != pix_sorted[:, :-1]
    winner_sorted = first & (pix_sorted < HW)

    # winners are distinct pixels, so their rank is a collision-free
    # address into an (H*W) buffer; non-winners go to a dump column
    rank = torch.cumsum(winner_sorted, dim=1, dtype=torch.int32) - 1
    dest = torch.where(winner_sorted, rank, HW).long()
    wslots = torch.full((B, HW + 1), CAP, dtype=torch.int32, device=dev)
    wslots = wslots.scatter(1, dest, slot_sorted)[:, :HW]  # CAP where none

    # ---- merge: O(H*W) ---------------------------------------------------
    wvalid = wslots < CAP
    maw = take(map_state.data, torch.clamp(wslots, max=CAP - 1))
    mpw, mnw, mcow, mccw = maw[..., 0:3], maw[..., 3:6], maw[..., 6:9], maw[..., 9:10]
    hw_w, ww_w, _ = _project_points_to_frame(mpw, wvalid, pose, intrinsics, H, W)
    pixw = hw_w * W + ww_w
    faw = take(frame_attr, torch.where(wvalid, pixw, 0))
    fpw, fnw, fcw = faw[..., 0:3], faw[..., 3:6], faw[..., 6:9]

    model_img = torch.full((B, HW + 1), CAP, dtype=torch.int32, device=dev)
    model_img = model_img.scatter(1, torch.where(wvalid, pixw, HW).long(), wslots)[:, :HW]

    alpha = torch.where(wvalid[..., None], faw[..., 9:10], 0.0)
    cc_new = mccw + alpha
    inv = 1.0 / torch.where(cc_new == 0, torch.ones_like(cc_new), cc_new)
    mrows = torch.cat(
        [
            (mccw * mpw + alpha * fpw) * inv,
            (mccw * mnw + alpha * fnw) * inv,
            (mccw * mcow + alpha * fcw) * inv,
            cc_new,
            maw[..., 10:12],
        ],
        dim=-1,
    )
    data = scatter_rows(map_state.data, wslots, mrows, wvalid)

    # ---- append every valid pixel without a winner -----------------------
    new_mask = valid_depth.reshape(B, HW) & (model_img >= CAP)
    frame_rows = torch.cat([frame_attr, frame_attr.new_zeros((B, HW, 2))], dim=-1)
    out = append_rows_to_map(MapState(data, map_state.num_points), frame_rows, new_mask)
    if not return_active:
        return out
    app_slot = map_state.num_points[:, None] + torch.cumsum(new_mask, dim=1, dtype=torch.int32) - 1
    app_valid = new_mask & (app_slot < CAP)
    model_img = torch.where(app_valid, app_slot, model_img)
    return out, (arena_slot, avalid, model_img)


def aggregate_map_dense(
    map_state: MapState,
    frame_vertex_global: torch.Tensor,
    frame_normal_global: torch.Tensor,
    frame_vertex_local: torch.Tensor,
    rgb_image: torch.Tensor,
    valid_depth: torch.Tensor,
    sigma: float = 0.6,
    frame_labels: Optional[torch.Tensor] = None,
) -> MapState:
    """Append-only map update: every valid-depth pixel is appended."""
    if frame_labels is not None:
        raise NotImplementedError("semantic label fusion waits for ROADMAP A8")
    B, H, W, _ = frame_vertex_global.shape
    HW = H * W
    alpha_img = get_alpha(frame_vertex_local, sigma, keepdim=True)
    return append_to_map(
        map_state,
        frame_vertex_global.reshape(B, HW, 3),
        frame_normal_global.reshape(B, HW, 3),
        rgb_image.reshape(B, HW, 3),
        alpha_img.reshape(B, HW, 1),
        valid_depth.reshape(B, HW),
    )
