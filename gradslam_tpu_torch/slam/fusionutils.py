"""PointFusion association and fusion (PyTorch port of
gradslam_tpu.slam.fusionutils: the exact path and the capacity-windowed
paths).

Association state is dense and of fixed size: the map rows active in the
live frame are compacted into an ``active_capacity`` buffer (or, with a
capacity window, the arena prefix is associated directly), one winner per
pixel is picked by :func:`ops.winner.pixel_winner` (max ccount, then min ray
distance, then min arena slot, as the reference's ``torch.unique`` row sort
does), winners get a confidence-weighted merge, and every other valid pixel
is appended to the arena.

The winner table is indexed by pixel, so it is the winner part of the model
image, and the merge reads the frame attributes at the table's own pixel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..geometry import project_points_to_pixels
from ..ops.masking import compact_masked
from ..ops.winner import pixel_winner, winner_keys
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


def _resolve_model_rows(mode: str, H: int, W: int, capacity: int) -> bool:
    """Resolves the ``model_rows`` option: True builds the projective
    odometry's target rows densely at fusion time ('dense'), False gathers
    the arena at the model image ('gather'); 'auto' is dense once the arena
    outgrows ``12*H*W`` rows, the JAX package's crossover."""
    if mode == "dense":
        return True
    if mode == "gather":
        return False
    if mode != "auto":
        raise ValueError(f"model_rows must be 'dense', 'gather' or 'auto', got {mode!r}")
    return capacity > 12 * H * W


def _resolve_assoc_window(assoc_window, capacity: int):
    """Resolves the ``assoc_window`` option: None (off) for ``<= 0`` or a
    window no smaller than the arena, else the number of prefix rows.

    Live rows are the contiguous prefix ``[0, num_points)``, so association
    can run on ``data[:, :assoc_window]``. Rows at slots ``>= assoc_window``
    are left out of association (not merged; their pixels may append a
    duplicate), as with ``active_capacity`` overflow.
    """
    if assoc_window is None or assoc_window <= 0:
        return None
    return assoc_window if assoc_window < capacity else None


def _take(x, idx):
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _merge_rows(rows, fa, alpha):
    """Confidence-weighted merge ``(c*m + a*f) / (c + a)`` of (..., 12) map
    rows with (..., 10) frame attributes at weight ``alpha`` (..., 1)."""
    cc = rows[..., 9:10]
    cc_new = cc + alpha
    inv = 1.0 / torch.where(cc_new == 0, torch.ones_like(cc_new), cc_new)
    return torch.cat(
        [
            (cc * rows[..., 0:3] + alpha * fa[..., 0:3]) * inv,
            (cc * rows[..., 3:6] + alpha * fa[..., 3:6]) * inv,
            (cc * rows[..., 6:9] + alpha * fa[..., 6:9]) * inv,
            cc_new,
            rows[..., 10:12],
        ],
        dim=-1,
    )


def _winner_slots(view, live, frame_attr, pose, intrinsics, dist_th, dot_th, H, W, A, CAP, compact):
    """Projective association and winner selection against a map view (the
    arena or its prefix window; view row == arena slot).

    ``compact`` compacts the active rows into the (B, A) buffer first;
    without it the view rows are the candidates (a window no larger than
    the buffer).

    Returns:
        (arena_slot, avalid, wslots): the (B, A) compacted slots and
        validity (or the view's, uncompacted) and the (B, H*W) winner slot
        at each pixel, CAP where none.
    """
    B, NA, _ = view.shape
    HW = H * W
    h, w, active = _project_points_to_frame(view[..., 0:3], live, pose, intrinsics, H, W)
    if compact:
        arena_slot, avalid = compact_masked(active, A)
        ma = _take(view, arena_slot)
        # the pixel again from the gathered rows: the same math on the same
        # values as the projection above
        ha, wa, _ = _project_points_to_frame(ma[..., 0:3], torch.ones_like(avalid), pose, intrinsics, H, W)
        pixa = ha * W + wa
    else:
        ma = view
        pixa = h * W + w
        arena_slot = torch.arange(NA, dtype=torch.int32, device=view.device).expand(B, NA)
        avalid = active
    mp, mn = ma[..., 0:3], ma[..., 3:6]
    fa = _take(frame_attr, pixa)
    fp, fn = fa[..., 0:3], fa[..., 3:6]
    gated = avalid & are_points_close(fp, mp, dist_th) & are_normals_similar(fn, mn, dot_th)
    pix_seg = torch.where(gated, pixa, HW)
    ray = ((mp - fp) ** 2).sum(-1)
    wslots = pixel_winner(pix_seg, *winner_keys(ma[..., 9], ray), arena_slot, HW, CAP)
    return arena_slot, avalid, wslots


def _fusion_window_dense(map_state, view, live, frame_attr, valid_depth, pose, intrinsics,
                         dist_th, dot_th, H, W, A, compact, return_active, dense_model_rows,
                         need_active_set=True):
    """Capacity-windowed fusion with the merge computed densely over the view.

    Every view row computes the value it would get as a winner from its own
    attributes and the frame's at its own pixel, and the winner mask
    selects it: the same winners, appends and model image as the rows path,
    merged floats to within rounding.

    ``compact`` bounds the candidates to the (B, A) buffer: it holds the
    active rows when the caller reuses them as odometry candidates
    (``need_active_set``), else the gated rows, which are the only rows
    that can win, so a full buffer drops nothing that could.
    """
    B, NT, _ = view.shape
    CAP = map_state.capacity
    HW = H * W
    dev = view.device

    h, w, active = _project_points_to_frame(view[..., 0:3], live, pose, intrinsics, H, W)
    pix = h * W + w
    fa = _take(frame_attr, pix)
    fp, fn = fa[..., 0:3], fa[..., 3:6]
    mp, mn = view[..., 0:3], view[..., 3:6]
    gated = active & are_points_close(fp, mp, dist_th) & are_normals_similar(fn, mn, dot_th)
    pix_seg = torch.where(gated, pix, HW)
    k_hi, k_lo = winner_keys(view[..., 9], ((mp - fp) ** 2).sum(-1))
    if compact:
        arena_slot, avalid = compact_masked(active if need_active_set else gated, A)
        idx = arena_slot.long()
        k_pix = torch.where(avalid, pix_seg.gather(1, idx), HW)
        k_hi, k_lo = k_hi.gather(1, idx), k_lo.gather(1, idx)
        k_slot = arena_slot
    else:
        k_pix = pix_seg
        arena_slot = k_slot = torch.arange(NT, dtype=torch.int32, device=dev).expand(B, NT)
        avalid = active
    model_img = pixel_winner(k_pix, k_hi, k_lo, k_slot, HW, CAP)  # winners only

    # per-view-row winner mask: one scatter of ones at the table's slots
    has_win = model_img < CAP
    wmask = torch.zeros((B, NT + 1), dtype=torch.bool, device=dev)
    wmask = wmask.scatter(1, torch.where(has_win, model_img, NT).long(), True)[:, :NT]

    new_view = torch.where(wmask[..., None], _merge_rows(view, fa, fa[..., 9:10]), view)
    data = torch.cat([new_view, map_state.data[:, NT:]], dim=1)
    win_rows = None
    if return_active and dense_model_rows:
        win_rows = _take(new_view, torch.clamp(model_img, max=NT - 1))
    return _append_frame(map_state, data, frame_attr, valid_depth, model_img, win_rows,
                         return_active, arena_slot, avalid, dense_model_rows)


def _append_frame(map_state, data, frame_attr, valid_depth, model_img, win_rows, return_active,
                  arena_slot, avalid, dense_model_rows):
    """Appends every valid pixel without a winner to the merged arena
    ``data`` and builds the returned tuple.

    ``model_img`` (B, H*W) holds the winner slot per pixel (CAP where none)
    and ``win_rows`` (B, H*W, 12) the merged row there (read only for the
    model rows).
    """
    B, HW, _ = frame_attr.shape
    CAP = map_state.capacity
    has_win = model_img < CAP
    new_mask = valid_depth.reshape(B, HW) & ~has_win
    frame_rows = torch.cat([frame_attr, frame_attr.new_zeros((B, HW, 2))], dim=-1)
    out = append_rows_to_map(MapState(data, map_state.num_points), frame_rows, new_mask)
    if not return_active:
        return out
    app_slot = map_state.num_points[:, None] + torch.cumsum(new_mask, dim=1, dtype=torch.int32) - 1
    app_valid = new_mask & (app_slot < CAP)
    img = torch.where(app_valid, app_slot, model_img)
    if not dense_model_rows:
        return out, (arena_slot, avalid, img)
    # model rows: the arena row at each pixel's model slot, from the buffers
    # in hand (winner pixels: the merged row; appended pixels: the frame row)
    mr6 = torch.where(has_win[..., None], win_rows[..., 0:6], 0.0)
    mr6 = torch.where(app_valid[..., None], frame_rows[..., 0:6], mr6)
    tval = (has_win | app_valid).to(mr6.dtype)
    return out, (arena_slot, avalid, img, torch.cat([mr6, tval[..., None]], dim=-1))


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
        assoc_window: ``> 0`` associates against the arena prefix
            ``data[:, :assoc_window]`` only (see :func:`_resolve_assoc_window`).
        dense_model_rows: also return the (B, H*W, 7) model rows
            ``[point(3), normal(3), valid(1)]``: the arena rows at the model
            image, built from this step's buffers.
        window_merge: the windowed path's merge, 'dense' (computed per view
            row, :func:`_fusion_window_dense`) or 'rows' (per winner, written
            back into the window); same winners and appends.
        need_active_set: False when the caller does not reuse the returned
            set as odometry candidates (projective odometry): the dense
            window path then compacts gated rows instead of active rows.
        block_size, visible_capacity, frame_labels: the spatial-block and
            semantic-label paths, not ported yet; a value that selects one
            raises.

    Returns:
        The new :class:`MapState`; with ``return_active`` also
        ``(arena_slot (B, A) int32, avalid (B, A) bool, model_img (B, H*W)
        int32[, model_rows])``: the next frame's odometry candidates and the
        arena slot fused at each pixel (CAP where none).
    """
    if window_merge not in ("dense", "rows"):
        raise ValueError(f"window_merge must be 'dense' or 'rows', got {window_merge!r}")
    if block_size is not None or visible_capacity is not None:
        raise NotImplementedError("fusion block gating waits for ROADMAP A8")
    if frame_labels is not None:
        raise NotImplementedError("semantic label fusion waits for ROADMAP A8")
    del merge_window
    B, H, W, _ = frame_vertex_global.shape
    CAP = map_state.capacity
    A = active_capacity
    # packed frame attributes: gv(3) gn(3) rgb(3) alpha(1) -> one gather
    alpha_img = get_alpha(frame_vertex_local, sigma, keepdim=True)
    frame_attr = torch.cat(
        [frame_vertex_global, frame_normal_global, rgb_image, alpha_img], dim=-1
    ).reshape(B, H * W, 10)

    win = _resolve_assoc_window(assoc_window, CAP)
    if win is None:
        view, live, compact = map_state.data, map_mask(map_state), True
    else:
        view = map_state.data[:, :win]
        live = torch.arange(win, dtype=torch.int32, device=view.device)[None, :] < map_state.num_points[:, None]
        compact = win > A
        if window_merge == "dense":
            return _fusion_window_dense(
                map_state, view, live, frame_attr, valid_depth, pose, intrinsics, dist_th, dot_th,
                H, W, A, compact, return_active, dense_model_rows, need_active_set,
            )
    arena_slot, avalid, wslots = _winner_slots(
        view, live, frame_attr, pose, intrinsics, dist_th, dot_th, H, W, A, CAP, compact
    )

    # ---- merge: O(H*W), the winner at each pixel with that pixel's frame row
    wvalid = wslots < CAP
    alpha = torch.where(wvalid[..., None], frame_attr[..., 9:10], 0.0)
    mrows = _merge_rows(_take(view, torch.clamp(wslots, max=view.shape[1] - 1)), frame_attr, alpha)
    data = scatter_rows(view, wslots, mrows, wvalid)  # winner slots are distinct
    if win is not None:  # the writeback stays inside the window
        data = torch.cat([data, map_state.data[:, win:]], dim=1)
    return _append_frame(map_state, data, frame_attr, valid_depth, wslots, mrows,
                         return_active, arena_slot, avalid, dense_model_rows)


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
