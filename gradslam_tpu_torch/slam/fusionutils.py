"""PointFusion association and fusion (PyTorch port of
gradslam_tpu.slam.fusionutils).

Association state is dense and of fixed size: the map rows active in the
live frame are compacted into an ``active_capacity`` buffer (or, with a
capacity window, the arena prefix is associated directly), one winner per
pixel is picked by :func:`ops.winner.pixel_winner` (max ccount, then min ray
distance, then min arena slot, as the reference's ``torch.unique`` row sort
does), winners get a confidence-weighted merge, and every other valid pixel
is appended to the arena.

The winner table is indexed by pixel, so it is the winner part of the model
image, and the merge reads the frame attributes at the table's own pixel.

With ``block_size`` the association runs on the visible blocks of the arena
only (:func:`visible_subarena`); with ``frame_labels`` the arena's channels
10-11 carry a per-point semantic label fused by streaming majority. The
dense association helpers (:func:`find_correspondences_dense`,
:func:`fuse_map_dense`) and the reference's table-based host API
(:func:`find_active_map_points` ... :func:`fuse_with_map`) sit at the
bottom; every winner of theirs is picked by the same winner kernel.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Union

import torch

from ..geometry import inverse_transformation, project_points_to_pixels, transform_pointcloud
from ..ops.masking import append_slots, compact_masked
from ..ops.winner import pixel_winner, winner_keys
from ..structures.maparena import (
    MapState,
    append_to_map,
    init_map,
    map_mask,
    map_to_pointclouds,
    pack_rows,
    scatter_rows,
)
from .mapshard import MapShard

__all__ = [
    "get_alpha",
    "are_points_close",
    "are_normals_similar",
    "DenseCorrespondence",
    "project_map_to_frame",
    "visible_subarena",
    "find_correspondences_dense",
    "fuse_map_dense",
    "fusion_update_compact",
    "aggregate_map_dense",
    "find_active_map_points",
    "find_similar_map_points",
    "find_best_unique_correspondences",
    "find_correspondences",
    "fuse_with_map",
    "update_map_fusion",
    "update_map_aggregate",
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


class DenseCorrespondence(NamedTuple):
    """Dense association state over the map arena.

    Attributes:
        winner: (B, CAP) bool, the slot is the best correspondence of its
            pixel.
        h, w: (B, CAP) int32 projected pixel of each slot (valid where
            ``active``).
        active: (B, CAP) bool, the slot projects inside the live frame.
        pix_corr: (B, H*W) bool, the pixel has a corresponding map point.
    """

    winner: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    active: torch.Tensor
    pix_corr: torch.Tensor


def _project_points_to_frame(points, live, pose, intrinsics, H, W):
    """(B, N, 3) world points -> pixel rows, cols and in-frame mask."""
    return project_points_to_pixels(points, live, pose, intrinsics, H, W)


def project_map_to_frame(map_state: MapState, pose, intrinsics, H: int, W: int):
    """Projects the live map points into the camera at ``pose``.

    Returns:
        (h, w, active): (B, CAP) int32 pixel rows and cols, bool mask.
    """
    return _project_points_to_frame(map_state.points, map_mask(map_state), pose, intrinsics, H, W)


def _pairwise_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)`` as a tree of elementwise adds (the axis zero-padded to
    a power of two, then halved): the bits of each sum do not depend on the
    sizes of the other axes, as a reduce kernel's may on the card, so a
    rank's blocks get one device's centroids."""
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = list(x.shape)
        pad[dim] = p - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _visible_blocks(pts, live_blk, pose, intrinsics, H: int, W: int) -> torch.Tensor:
    """(B, NB) mask of the blocks (B, NB, BLK, 3) points with their
    (B, NB, BLK) live mask whose bounding sphere over their live rows can
    project into the frame: a conservative sphere-vs-frustum test."""
    lv = live_blk[..., None].to(pts.dtype)
    n_in_block = torch.clamp(lv.sum(dim=2), min=1.0)  # (B, NB, 1), exact
    centroid = _pairwise_sum(pts * lv, 2) / n_in_block  # (B, NB, 3)
    radius = torch.sqrt(
        torch.amax(((pts - centroid[:, :, None]) ** 2).sum(-1) * lv[..., 0], dim=2)
    )  # (B, NB)
    block_live = live_blk.any(dim=2)

    # conservative sphere-vs-frustum test in camera space
    c_cam = transform_pointcloud(centroid, inverse_transformation(pose))
    z = c_cam[..., 2]
    K = intrinsics[:, 0] if intrinsics.dim() == 4 else intrinsics
    fx, fy = K[..., 0, 0][:, None], K[..., 1, 1][:, None]
    cx, cy = K[..., 0, 2][:, None], K[..., 1, 2][:, None]
    # a sphere crossing or behind the image plane is visible
    near = z - radius <= 1e-3
    z_safe = torch.clamp(z - radius, min=1e-3)
    z_div = torch.where(z != 0, z, torch.ones_like(z))
    u = (c_cam[..., 0] * fx + z * cx) / z_div
    v = (c_cam[..., 1] * fy + z * cy) / z_div
    mu = radius * fx.abs() / z_safe
    mv = radius * fy.abs() / z_safe
    in_view = (
        (u + mu > -1.0) & (u - mu < W + 1.0) & (v + mv > -1.0) & (v - mv < H + 1.0) & (z + radius > 0)
    )
    return block_live & (in_view | near)


def visible_subarena(map_state: MapState, pose, intrinsics, H: int, W: int, block_size: int,
                     visible_capacity: int):
    """Block-gated view of the arena: the blocks whose bounding sphere can
    project into the frame.

    The arena is ``NB = ceil(CAP / block_size)`` contiguous blocks (the last
    one zero-padded). Each block's centroid and radius over its live rows
    go through a conservative sphere-vs-frustum test; the visible blocks,
    at most ``visible_capacity`` (the lowest-index ones past that), are
    gathered block by block into a sub-arena. The test only selects, so it
    runs without autograd; the gathered rows keep their gradient.

    Returns:
        (sub_data (B, V*BLK, 12), sub_slots (B, V*BLK) int32 arena slots,
        sub_live (B, V*BLK) bool); rows of padding and of unused block
        entries are dead, and padding rows are zero.
    """
    data = map_state.data
    B, CAP, C = data.shape
    BLK, V = block_size, visible_capacity
    NB = -(-CAP // BLK)
    pad = NB * BLK - CAP
    live = map_mask(map_state)
    with torch.no_grad():
        pts = torch.nn.functional.pad(data[..., 0:3], (0, 0, 0, pad)).reshape(B, NB, BLK, 3)
        live_blk = torch.nn.functional.pad(live, (0, pad)).reshape(B, NB, BLK)
        blk_idx, blk_valid = compact_masked(_visible_blocks(pts, live_blk, pose, intrinsics, H, W), V)  # (B, V)

        offs = torch.arange(BLK, dtype=torch.int32, device=data.device)
        sub_slots = (blk_idx[:, :, None] * BLK + offs).reshape(B, V * BLK)
        sub_live = live_blk.gather(1, blk_idx.long()[..., None].expand(B, V, BLK))
        sub_live = (sub_live & blk_valid[..., None]).reshape(B, V * BLK)
    # the block gathers, as rows of the arena; padding rows read as zero
    in_arena = sub_slots < CAP
    sub_data = _take(data, torch.clamp(sub_slots, max=CAP - 1))
    if pad:
        sub_data = torch.where(in_arena[..., None], sub_data, 0.0)
    return sub_data, sub_slots, sub_live


def _visible_subarena_shard(map_state: MapState, pose, intrinsics, H: int, W: int, block_size: int,
                            visible_capacity: int, shard):
    """:func:`visible_subarena` on a map shard: this rank's part of the
    global arena's sub-arena, the rows it holds of the global arena's
    ``visible_capacity`` lowest-index visible blocks.

    A rank tests the blocks it holds rows of. A block that straddles ranks
    (``rows % block_size != 0``) is first assembled on each of them from its
    owners' rows (one owner-placed sum), so its centroid and radius are one
    device's bits. The block flags meet in one (B, NB) owner-placed sum,
    each from the rank that holds the block's first row; every rank
    compacts that global list and gathers the rows it holds of the listed
    blocks, ``VR = min(visible_capacity, blocks it holds rows of)`` blocks.

    Returns:
        (sub_data (B, VR*BLK, 12) local rows, sub_slots (B, VR*BLK) int32
        global slots, ascending on the blocks in use, sub_live
        (B, VR*BLK) bool); rows of other ranks, of padding and of unused
        block entries are dead, and those of other ranks and of padding
        are zero.
    """
    data = map_state.data
    B, R, _ = data.shape
    BLK, CAP, off = block_size, shard.capacity, shard.offset
    NB = -(-CAP // BLK)
    b0, b1 = off // BLK, -(-(off + R) // BLK)  # the blocks this rank holds rows of
    lead, trail = off - b0 * BLK, b1 * BLK - off - R
    # blocks whose rows (inside the arena) lie on more than one rank: the same list everywhere
    shared = [j for j in range(NB) if (j * BLK) // R != (min((j + 1) * BLK, CAP) - 1) // R]
    with torch.no_grad():
        pts = torch.nn.functional.pad(data[..., 0:3], (0, 0, lead, trail)).reshape(B, b1 - b0, BLK, 3)
        live_blk = torch.nn.functional.pad(shard.live(map_state), (lead, trail)).reshape(B, b1 - b0, BLK)
        if shared:
            mine = [(s, j - b0) for s, j in enumerate(shared) if b0 <= j < b1]
            buf = data.new_zeros((B, len(shared), BLK, 4))
            for s, k in mine:
                buf[:, s] = torch.cat([pts[:, k], live_blk[:, k, :, None].to(pts.dtype)], dim=-1)
            buf = shard.assemble(buf)
            for s, k in mine:
                pts[:, k], live_blk[:, k] = buf[:, s, :, 0:3], buf[:, s, :, 3] > 0
        vis = _visible_blocks(pts, live_blk, pose, intrinsics, H, W)
        first = torch.arange(b0, b1, device=data.device) * BLK >= off  # the block's first row is here
        flags = torch.zeros((B, NB), dtype=torch.int32, device=data.device)
        flags[:, b0:b1] = (vis & first).to(torch.int32)
        blk_idx, blk_valid = compact_masked(shard.all_reduce(flags) > 0, visible_capacity)
        sel = torch.zeros((B, NB + 1), dtype=torch.bool, device=data.device)
        sel = sel.scatter(1, torch.where(blk_valid, blk_idx, NB).long(), True)[:, b0:b1]
        loc, loc_valid = compact_masked(sel, min(visible_capacity, b1 - b0))  # (B, VR)
        VR = loc.shape[1]
        offs = torch.arange(BLK, dtype=torch.int32, device=data.device)
        sub_slots = ((loc + b0)[:, :, None] * BLK + offs).reshape(B, VR * BLK)
        own = shard.owns(sub_slots)
        in_use = loc_valid[:, :, None].expand(B, VR, BLK).reshape(B, VR * BLK)
        sub_live = own & in_use & (sub_slots < map_state.num_points[:, None])
    sub_data = torch.where(own[..., None], _take(data, shard.local(sub_slots)), 0.0)
    return sub_data, sub_slots, sub_live


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
    rows with (..., 10) frame attributes at weight ``alpha`` (..., 1).

    With (..., 11) attributes (the frame label last) the label channels
    take the streaming-majority update: a matching label adds ``alpha`` to
    the confidence, another one subtracts it, and the label flips where the
    confidence drops below zero. Otherwise they are copied unchanged.
    """
    cc = rows[..., 9:10]
    cc_new = cc + alpha
    inv = 1.0 / torch.where(cc_new == 0, torch.ones_like(cc_new), cc_new)
    if fa.shape[-1] > 10:
        mlab, mconf, flab = rows[..., 10:11], rows[..., 11:12], fa[..., 10:11]
        conf_new = torch.where(mlab == flab, mconf + alpha, mconf - alpha)
        label_ch = [torch.where(conf_new >= 0, mlab, flab), conf_new.abs()]
    else:
        label_ch = [rows[..., 10:12]]
    return torch.cat(
        [
            (cc * rows[..., 0:3] + alpha * fa[..., 0:3]) * inv,
            (cc * rows[..., 3:6] + alpha * fa[..., 3:6]) * inv,
            (cc * rows[..., 6:9] + alpha * fa[..., 6:9]) * inv,
            cc_new,
            *label_ch,
        ],
        dim=-1,
    )


def _winner_slots(view, live, frame_attr, pose, intrinsics, dist_th, dot_th, H, W, A, compact, shard,
                  src_slots=None, win=None):
    """Projective association and winner selection against a map view: the
    arena, its prefix window, or the block-gated sub-arena whose rows sit
    at arena slots ``src_slots`` (None: view row == local row).

    ``compact`` compacts the active rows into the (B, A) buffer first;
    without it the view rows are the candidates (a prefix window of ``win``
    rows, no larger than the buffer).

    The view is this rank's part of the arena's (``shard``, a
    :class:`~gradslam_tpu_torch.slam.mapshard.MapShard`; the whole of it on
    one process): its local rows ``[0, NA)`` (``live`` False past the
    window) or its part of the gated sub-arena. The buffer is the global
    one, of which this rank selects among the rows it holds, and the group
    then takes the least key of the ranks' winners (:meth:`MapShard.winner`).

    Returns:
        (arena_slot, avalid, wslots): the (B, A) compacted arena slots and
        validity (or the window's, uncompacted) and the (B, H*W) arena slot
        of the winner at each pixel, CAP where none; the same on every rank.
    """
    B, NA, _ = view.shape
    HW, CAP = H * W, shard.capacity
    h, w, active = _project_points_to_frame(view[..., 0:3], live, pose, intrinsics, H, W)
    if compact:
        idx, avalid, cand_slots, cand_valid = shard.compact(active, A, src_slots)
        ma = _take(view, idx)
        arena_slot = idx + shard.offset if src_slots is None else src_slots.gather(1, idx.long())
        rows = idx.long()
        pixa = h.gather(1, rows) * W + w.gather(1, rows)
        sorted_slots = torch.where(avalid, arena_slot, CAP)
    else:
        ma, pixa, avalid = view, h * W + w, active
        arena_slot = sorted_slots = shard.slots(NA, view.device).expand(B, NA)
        cand_slots = torch.arange(win, dtype=torch.int32, device=view.device).expand(B, win)
        cand_valid = shard.assemble_prefix(active, win)
    mp, mn = ma[..., 0:3], ma[..., 3:6]
    fa = _take(frame_attr, pixa)
    fp, fn = fa[..., 0:3], fa[..., 3:6]
    gated = avalid & are_points_close(fp, mp, dist_th) & are_normals_similar(fn, mn, dot_th)
    pix_seg = torch.where(gated, pixa, HW)
    ray = ((mp - fp) ** 2).sum(-1)
    k_hi, k_lo = winner_keys(ma[..., 9], ray)
    wslots = pixel_winner(pix_seg, k_hi, k_lo, arena_slot, HW, CAP)
    return cand_slots, cand_valid, shard.winner(wslots, sorted_slots, k_hi, k_lo)


def _fusion_window_dense(map_state, view, live, frame_attr, valid_depth, pose, intrinsics,
                         dist_th, dot_th, H, W, A, compact, return_active, dense_model_rows,
                         need_active_set, shard, win):
    """Capacity-windowed fusion with the merge computed densely over the view.

    Every view row computes the value it would get as a winner from its own
    attributes and the frame's at its own pixel, and the winner mask
    selects it: the same winners, appends and model image as the rows path,
    merged floats to within rounding.

    ``compact`` bounds the candidates to the (B, A) buffer: it holds the
    active rows when the caller reuses them as odometry candidates
    (``need_active_set``), else the gated rows, which are the only rows
    that can win, so a full buffer drops nothing that could.

    The view is this rank's local rows ``[0, NT)`` of the ``win``-row window
    (``live`` False past it): the candidate list is the global one
    (:meth:`MapShard.compact`), the winners the group's
    (:meth:`MapShard.winner`), and each rank merges the winners it holds;
    the model rows are assembled from their owners.
    """
    B, NT, _ = view.shape
    CAP, off = shard.capacity, shard.offset
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
        loc, kvalid, arena_slot, avalid = shard.compact(active if need_active_set else gated, A)
        idx = loc.long()
        k_slot = loc + off
        k_pix = torch.where(kvalid, pix_seg.gather(1, idx), HW)
        k_hi, k_lo = k_hi.gather(1, idx), k_lo.gather(1, idx)
        sorted_slots = torch.where(kvalid, k_slot, CAP)
    else:
        k_pix = pix_seg
        k_slot = sorted_slots = shard.slots(NT, dev).expand(B, NT)
        arena_slot = torch.arange(win, dtype=torch.int32, device=dev).expand(B, win)
        avalid = shard.assemble_prefix(active, win)
    model_img = pixel_winner(k_pix, k_hi, k_lo, k_slot, HW, CAP)  # winners only
    model_img = shard.winner(model_img, sorted_slots, k_hi, k_lo)

    # per-view-row winner mask: one scatter of ones at the table's slots
    mine = (model_img >= off) & (model_img < off + NT)
    wmask = torch.zeros((B, NT + 1), dtype=torch.bool, device=dev)
    wmask = wmask.scatter(1, torch.where(mine, model_img - off, NT).long(), True)[:, :NT]

    new_view = torch.where(wmask[..., None], _merge_rows(view, fa, fa[..., 9:10]), view)
    data = torch.cat([new_view, map_state.data[:, NT:]], dim=1)
    win_rows = None
    if return_active and dense_model_rows:
        win_rows = _take(new_view[..., 0:6], torch.clamp(model_img - off, 0, NT - 1))
        win_rows = shard.assemble(win_rows, mine[..., None])
    return _append_frame(map_state, data, frame_attr, valid_depth, model_img, win_rows,
                         return_active, arena_slot, avalid, dense_model_rows, shard)


def _append_frame(map_state, data, frame_attr, valid_depth, model_img, win_rows, return_active,
                  arena_slot, avalid, dense_model_rows, shard):
    """Appends every valid pixel without a winner to the merged arena
    ``data`` (this rank's part of it; the slots are global) and builds the
    returned tuple.

    ``model_img`` (B, H*W) holds the winner slot per pixel (CAP where none)
    and ``win_rows`` (B, H*W, 6) the merged row's point and normal there
    (read only for the model rows).
    """
    B, HW, _ = frame_attr.shape
    CAP = shard.capacity
    has_win = model_img < CAP
    new_mask = valid_depth.reshape(B, HW) & ~has_win
    # appended points carry their frame label at confidence alpha
    tail = frame_attr[..., 9:10] if frame_attr.shape[-1] > 10 else frame_attr.new_zeros((B, HW, 2))
    frame_rows = torch.cat([frame_attr, tail], dim=-1)
    appended = append_slots(map_state.num_points, new_mask)
    out = shard.append_rows(MapState(data, map_state.num_points), frame_rows, new_mask, appended)
    if not return_active:
        return out
    app_slot = appended[0]
    app_valid = new_mask & (app_slot < CAP)
    img = torch.where(app_valid, app_slot, model_img)
    if not dense_model_rows:
        return out, (arena_slot, avalid, img)
    # model rows: the arena row at each pixel's model slot, from the buffers
    # in hand (winner pixels: the merged row; appended pixels: the frame row)
    mr6 = torch.where(has_win[..., None], win_rows, 0.0)
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
    shard=None,
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
        block_size: associate against the visible blocks of this many rows
            only (:func:`visible_subarena`), at most ``visible_capacity``
            of them (default ``max(8, ceil(4*H*W / block_size))``); the
            merge writes into the whole arena. ``assoc_window`` is ignored
            on this path, and ``visible_capacity`` without ``block_size``.
        frame_labels: (B, H, W) semantic labels, fused into the arena's
            channels 10-11 by streaming majority (see :func:`_merge_rows`);
            an appended point starts at confidence alpha. Labels enter no
            gate or winner key, so channels 0-9 are those of a run without.
        shard: a :class:`~gradslam_tpu_torch.slam.mapshard.MapShard` when
            ``map_state`` is this rank's part of an arena partitioned over a
            group (every rank of the group calls with the same frame), on
            every path above (None: :meth:`MapShard.whole`, one process).
            The candidate lists are the global ones, the winners the
            group's, and the winner's owner merges it; block gating gathers
            the rows the rank holds of the global visible blocks
            (:func:`_visible_subarena_shard`), and a window covers the
            rank's rows below it. The returned set, model image and model
            rows are global and the same on every rank; the new state is
            this rank's part.

    Returns:
        The new :class:`MapState`; with ``return_active`` also
        ``(arena_slot (B, A) int32, avalid (B, A) bool, model_img (B, H*W)
        int32[, model_rows])``: the next frame's odometry candidates and the
        arena slot fused at each pixel (CAP where none).
    """
    if window_merge not in ("dense", "rows"):
        raise ValueError(f"window_merge must be 'dense' or 'rows', got {window_merge!r}")
    del merge_window
    B, H, W, _ = frame_vertex_global.shape
    HW = H * W
    CAP = map_state.capacity
    A = active_capacity
    # packed frame attributes: gv(3) gn(3) rgb(3) alpha(1) [label(1)] -> one gather
    alpha_img = get_alpha(frame_vertex_local, sigma, keepdim=True)
    attrs = [frame_vertex_global, frame_normal_global, rgb_image, alpha_img]
    if frame_labels is not None:
        attrs.append(frame_labels.reshape(B, H, W, 1).to(alpha_img.dtype))
    frame_attr = torch.cat(attrs, dim=-1).reshape(B, HW, -1)

    if shard is None:
        shard = MapShard.whole(CAP)
    CAP = shard.capacity
    data = map_state.data
    if block_size is not None:
        vcap = visible_capacity or max(8, (4 * HW + block_size - 1) // block_size)
        if shard.n == 1:
            sub, sub_slots, sub_live = visible_subarena(map_state, pose, intrinsics, H, W, block_size, vcap)
        else:
            sub, sub_slots, sub_live = _visible_subarena_shard(
                map_state, pose, intrinsics, H, W, block_size, vcap, shard
            )
        arena_slot, avalid, wslots = _winner_slots(
            sub, sub_live, frame_attr, pose, intrinsics, dist_th, dot_th, H, W, A, True, shard, sub_slots
        )
    else:
        win = _resolve_assoc_window(assoc_window, CAP)
        view, live = shard.window(map_state, win)
        compact = win is None or win > A
        if win is not None and window_merge == "dense":
            return _fusion_window_dense(
                map_state, view, live, frame_attr, valid_depth, pose, intrinsics, dist_th, dot_th,
                H, W, A, compact, return_active, dense_model_rows, need_active_set, shard, win,
            )
        arena_slot, avalid, wslots = _winner_slots(
            view, live, frame_attr, pose, intrinsics, dist_th, dot_th, H, W, A, compact, shard, win=win
        )

    # ---- merge: O(H*W), the winner at each pixel with that pixel's frame
    # row, by the winner's owner (winner slots are distinct)
    wvalid = wslots < CAP
    alpha = torch.where(wvalid[..., None], frame_attr[..., 9:10], 0.0)
    owned = wvalid & shard.owns(wslots)
    rows = shard.local(wslots)
    mrows = _merge_rows(_take(data, rows), frame_attr, alpha)
    data = scatter_rows(data, rows, mrows, owned)
    win_rows = shard.assemble(mrows[..., 0:6], owned[..., None]) if return_active and dense_model_rows else None
    return _append_frame(map_state, data, frame_attr, valid_depth, wslots, win_rows, return_active,
                         arena_slot, avalid, dense_model_rows, shard)


def aggregate_map_dense(
    map_state: MapState,
    frame_vertex_global: torch.Tensor,
    frame_normal_global: torch.Tensor,
    frame_vertex_local: torch.Tensor,
    rgb_image: torch.Tensor,
    valid_depth: torch.Tensor,
    sigma: float = 0.6,
    frame_labels: Optional[torch.Tensor] = None,
    shard=None,
) -> MapState:
    """Append-only map update: every valid-depth pixel is appended. With
    ``frame_labels`` (B, H, W) each point carries its label at confidence
    alpha in channels 10-11. With a ``shard`` (see
    :func:`fusion_update_compact`) each rank writes the appended rows it
    holds (:meth:`MapShard.append_rows`)."""
    B, H, W, _ = frame_vertex_global.shape
    HW = H * W
    alpha = get_alpha(frame_vertex_local, sigma, keepdim=True).reshape(B, HW, 1)
    gv, gn, rgb = (x.reshape(B, HW, 3) for x in (frame_vertex_global, frame_normal_global, rgb_image))
    if frame_labels is not None:
        rows = torch.cat([gv, gn, rgb, alpha, frame_labels.reshape(B, HW, 1).to(alpha.dtype), alpha], dim=-1)
    else:
        rows = pack_rows(gv, gn, rgb, alpha)
    if shard is None:
        shard = MapShard.whole(map_state.capacity)
    mask = valid_depth.reshape(B, HW)
    return shard.append_rows(map_state, rows, mask, append_slots(map_state.num_points, mask))


# ---------------------------------------------------------------------------
# Dense association over the whole arena
# ---------------------------------------------------------------------------


def _gather_pixels(img, h, w):
    """(B, H, W, C) images at (B, N) pixel rows and columns -> (B, N, C)."""
    B, H, W, C = img.shape
    return _take(img.reshape(B, H * W, C), h * W + w)


def find_correspondences_dense(
    map_state: MapState,
    frame_vertex_global: torch.Tensor,
    frame_normal_global: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    dist_th: float,
    dot_th: float,
) -> DenseCorrespondence:
    """Projective association, dense over the arena: the map slots that
    project into the live frame, pass the distance and normal gates
    against the frame at their pixel, and win their pixel (max ccount, then
    min ray distance, then min slot: one :func:`pixel_winner` selection
    with the arena slot as the slot).

    Args:
        frame_vertex_global / frame_normal_global: (B, H, W, 3).
        pose: (B, 4, 4) live pose; intrinsics: (B, 1, 4, 4).
    """
    B, H, W, _ = frame_vertex_global.shape
    CAP = map_state.capacity
    HW = H * W
    h, w, active = project_map_to_frame(map_state, pose, intrinsics, H, W)
    fp = _gather_pixels(frame_vertex_global, h, w)
    fn = _gather_pixels(frame_normal_global, h, w)
    mp = map_state.points
    gated = active & are_points_close(fp, mp, dist_th) & are_normals_similar(fn, map_state.normals, dot_th)
    pix_seg = torch.where(gated, h * W + w, HW)
    slot = torch.arange(CAP, dtype=torch.int32, device=mp.device).expand(B, CAP)
    k_hi, k_lo = winner_keys(map_state.ccounts[..., 0], ((mp - fp) ** 2).sum(-1))
    slots = pixel_winner(pix_seg, k_hi, k_lo, slot, HW, CAP)
    pix_corr = slots < CAP
    winner = torch.zeros((B, CAP + 1), dtype=torch.bool, device=mp.device)
    winner = winner.scatter(1, torch.where(pix_corr, slots, CAP).long(), True)[:, :CAP]
    return DenseCorrespondence(winner=winner, h=h, w=w, active=active, pix_corr=pix_corr)


def fuse_map_dense(
    map_state: MapState,
    corr: DenseCorrespondence,
    frame_vertex_global: torch.Tensor,
    frame_normal_global: torch.Tensor,
    frame_vertex_local: torch.Tensor,
    rgb_image: torch.Tensor,
    valid_depth: torch.Tensor,
    sigma: float,
) -> MapState:
    """PointFusion map update from a :class:`DenseCorrespondence`: the
    winners get the confidence-weighted average ``(c*m + a*f) / (c + a)``
    of points, normals and colors, and every valid-depth pixel without a
    correspondence is appended with confidence ``alpha``. The label
    channels are reset to zero, as the JAX package's ``from_arrays`` does.
    """
    B, H, W, _ = frame_vertex_global.shape
    alpha_img = get_alpha(frame_vertex_local, sigma, keepdim=True)
    fp = _gather_pixels(frame_vertex_global, corr.h, corr.w)
    fn = _gather_pixels(frame_normal_global, corr.h, corr.w)
    fc = _gather_pixels(rgb_image, corr.h, corr.w)
    fa = _gather_pixels(alpha_img, corr.h, corr.w)
    win = corr.winner[..., None]
    alpha = torch.where(win, fa, torch.zeros_like(fa))
    cc = map_state.ccounts
    cc_new = cc + alpha
    inv = 1.0 / torch.where(cc_new == 0, torch.ones_like(cc_new), cc_new)

    def merge(old, frame):
        return torch.where(win, (cc * old + alpha * frame) * inv, old)

    merged = MapState(
        pack_rows(
            merge(map_state.points, fp), merge(map_state.normals, fn), merge(map_state.colors, fc),
            torch.where(win, cc_new, cc),
        ),
        map_state.num_points,
    )
    HW = H * W
    return append_to_map(
        merged,
        frame_vertex_global.reshape(B, HW, 3),
        frame_normal_global.reshape(B, HW, 3),
        rgb_image.reshape(B, HW, 3),
        alpha_img.reshape(B, HW, 1),
        valid_depth.reshape(B, HW) & ~corr.pix_corr,
    )


# ---------------------------------------------------------------------------
# The reference's table-based host API: (num_rows, 4) int64 [b, n, h, w]
# tables over Pointclouds. The tables are ragged, so building one asks the
# host for its length (torch.nonzero).
# ---------------------------------------------------------------------------


def _pointclouds_to_mapstate(pointclouds) -> MapState:
    pts = pointclouds.points_padded
    feats = pointclouds.features_padded
    if feats is None:
        feats = pts.new_zeros(pts.shape[:2] + (1,))
    normals = pointclouds.normals_padded
    colors = pointclouds.colors_padded
    return MapState(
        pack_rows(
            pts,
            torch.zeros_like(pts) if normals is None else normals,
            torch.zeros_like(pts) if colors is None else colors,
            feats,
        ),
        pointclouds.num_points_per_pointcloud,
    )


def _empty_table(device):
    return torch.zeros((0, 4), dtype=torch.int64, device=device)


def _table_from_mask(mask, h, w):
    """(B, CAP) mask -> (num_rows, 4) int64 [b, n, h, w] table."""
    b, n = torch.nonzero(mask, as_tuple=True)
    return torch.stack([b, n, h[b, n].long(), w[b, n].long()], dim=-1)


def find_active_map_points(pointclouds, rgbdimages) -> torch.Tensor:
    """The map points that project into the live (B, 1) frame.

    Returns:
        (num_active, 4) int64 table of ``[batch, point, h, w]`` rows,
        ordered by batch entry and point.
    """
    if not pointclouds.has_points:
        return _empty_table(pointclouds.device)
    rgbd = rgbdimages.to_channels_last()
    B, L, H, W = rgbd.shape
    if L != 1:
        raise ValueError(f"expected sequence length 1, got {L}")
    h, w, active = project_map_to_frame(
        _pointclouds_to_mapstate(pointclouds), rgbd.poses[:, 0], rgbd.intrinsics, H, W
    )
    table = _table_from_mask(active, h, w)
    if table.shape[0] == 0:
        warnings.warn("No active map points were found")
    return table


def find_similar_map_points(pointclouds, rgbdimages, pc2im_bnhw, dist_th, dot_th):
    """The rows of an active table whose map point passes the distance and
    normal gates against the frame at its pixel.

    Returns:
        (pc2im_bnhw_similar, is_similar_mask (num_active,) bool).
    """
    if pc2im_bnhw.shape[0] == 0:
        dev = pc2im_bnhw.device
        return _empty_table(dev), torch.zeros((0,), dtype=torch.bool, device=dev)
    if not pointclouds.has_normals:
        raise ValueError("pointclouds must have normals")
    rgbd = rgbdimages.to_channels_last()
    b, n, h, w = pc2im_bnhw.long().unbind(1)
    fp = rgbd.global_vertex_map[:, 0][b, h, w]
    fn = rgbd.global_normal_map[:, 0][b, h, w]
    mp = pointclouds.points_padded[b, n]
    mn = pointclouds.normals_padded[b, n]
    keep = are_points_close(fp, mp, dist_th) & are_normals_similar(fn, mn, dot_th)
    out = pc2im_bnhw[keep]
    if out.shape[0] == 0:
        warnings.warn(
            "No similar map points were found (despite total {0} active "
            "points across the batch)".format(pc2im_bnhw.shape[0]),
            RuntimeWarning,
        )
    return out, keep


def find_best_unique_correspondences(pointclouds, rgbdimages, pc2im_bnhw) -> torch.Tensor:
    """One row per pixel among a table's rows: the highest ccount, then the
    smallest squared ray distance, then the smallest point index.

    The rows go through :func:`pixel_winner` per batch entry (pixel
    ``h*W + w``, the point index as the slot), padded to the longest entry
    with rows at no pixel.

    Returns:
        The winning rows, ordered by ``(batch, h, w)``.
    """
    if pc2im_bnhw.shape[0] == 0:
        return _empty_table(pc2im_bnhw.device)
    if not pointclouds.has_features:
        raise ValueError("pointclouds must have features (ccounts)")
    rgbd = rgbdimages.to_channels_last()
    B, _, H, W = rgbd.shape
    HW = H * W
    tab = pc2im_bnhw.long()
    b, n, h, w = tab.unbind(1)
    cc = pointclouds.features_padded[b, n, 0]
    ray = ((pointclouds.points_padded[b, n] - rgbd.global_vertex_map[:, 0][b, h, w]) ** 2).sum(-1)
    k_hi, k_lo = winner_keys(cc, ray)
    # each row's column in its batch entry's padded row of candidates
    counts = torch.bincount(b, minlength=B)
    order = torch.argsort(b, stable=True)
    col = torch.empty_like(b)
    col[order] = torch.arange(b.shape[0], device=b.device) - (torch.cumsum(counts, 0) - counts)[b[order]]
    n_max = int(counts.max())

    def padded(val, fill):
        out = torch.full((B, n_max), fill, dtype=val.dtype, device=val.device)
        out[b, col] = val
        return out

    sentinel = pointclouds.capacity
    slots = pixel_winner(
        padded((h * W + w).to(torch.int32), HW), padded(k_hi, 0), padded(k_lo, 0),
        padded(n.to(torch.int32), 0), HW, sentinel,
    )
    wb, wp = torch.nonzero(slots < sentinel, as_tuple=True)
    return torch.stack([wb, slots[wb, wp].long(), wp // W, wp % W], dim=-1)


def find_correspondences(pointclouds, rgbdimages, dist_th, dot_th) -> torch.Tensor:
    """The association pipeline: active, then similar, then the best unique
    row per pixel."""
    pc2im = find_active_map_points(pointclouds, rgbdimages)
    pc2im, _ = find_similar_map_points(pointclouds, rgbdimages, pc2im, dist_th, dot_th)
    return find_best_unique_correspondences(pointclouds, rgbdimages, pc2im)


def _rgbd_frame_arrays(rgbd):
    return (
        rgbd.global_vertex_map[:, 0],
        rgbd.global_normal_map[:, 0],
        rgbd.vertex_map[:, 0],
        rgbd.rgb_image[:, 0],
        rgbd.valid_depth_mask[:, 0, ..., 0],
    )


def update_map_fusion(pointclouds, rgbdimages, dist_th, dot_th, sigma):
    """PointFusion update on the :class:`Pointclouds` API: the dense
    association and fusion over an arena one frame larger than the map.

    Returns:
        The fused map as a new :class:`Pointclouds` (ccounts as features).
    """
    rgbd = rgbdimages.to_channels_last()
    B, L, H, W = rgbd.shape
    if len(pointclouds) == 0:
        ms = init_map(B, 0, rgbd.rgb_image.dtype, device=rgbd.device)
    else:
        ms = _pointclouds_to_mapstate(pointclouds)
    ms = MapState(torch.nn.functional.pad(ms.data, (0, 0, 0, H * W)), ms.num_points)
    gv, gn, lv, rgb, vd = _rgbd_frame_arrays(rgbd)
    corr = find_correspondences_dense(ms, gv, gn, rgbd.poses[:, 0], rgbd.intrinsics, dist_th, dot_th)
    return map_to_pointclouds(fuse_map_dense(ms, corr, gv, gn, lv, rgb, vd, sigma))


def update_map_aggregate(pointclouds, rgbdimages, inplace: bool = False):
    """Append-only update on the :class:`Pointclouds` API: every
    valid-depth pixel of the (B, 1) frame, in world coordinates."""
    from ..structures.utils import pointclouds_from_rgbdimages

    return pointclouds.append_points(pointclouds_from_rgbdimages(rgbdimages, global_coordinates=True))


def fuse_with_map(pointclouds, rgbdimages, pc2im_bnhw, sigma, inplace: bool = False):
    """Table-based fusion: the confidence-weighted merge at the rows of
    ``pc2im_bnhw``, then every valid-depth pixel without a row appended.

    Returns:
        A new :class:`Pointclouds`.
    """
    from ..structures import Pointclouds

    rgbd = rgbdimages.to_channels_last()
    B, L, H, W = rgbd.shape
    gv, gn, lv, rgb, vd = _rgbd_frame_arrays(rgbd)
    alpha_img = get_alpha(lv, sigma, keepdim=True)
    new_mask = vd.bool()
    if pointclouds.has_points and pc2im_bnhw.shape[0] != 0:
        b, n, h, w = pc2im_bnhw.long().unbind(1)
        fa = alpha_img[b, h, w]
        cc_rows = pointclouds.features_padded[b, n]
        cc_new_rows = cc_rows + fa

        def merge(old_all, frame_rows):
            out = old_all.clone()
            out[b, n] = (cc_rows * old_all[b, n] + fa * frame_rows) / cc_new_rows
            return out

        pointclouds = pointclouds.clone()
        pointclouds.points_padded = merge(pointclouds.points_padded, gv[b, h, w])
        pointclouds.normals_padded = merge(pointclouds.normals_padded, gn[b, h, w])
        pointclouds.colors_padded = merge(pointclouds.colors_padded, rgb[b, h, w])
        feats = pointclouds.features_padded.clone()
        feats[b, n] = cc_new_rows
        pointclouds.features_padded = feats
        corr_px = torch.zeros((B, H, W), dtype=torch.bool, device=new_mask.device)
        corr_px[b, h, w] = True
        new_mask = new_mask & ~corr_px
    new_pc = Pointclouds(
        points=[gv[i][new_mask[i]] for i in range(B)],
        normals=[gn[i][new_mask[i]] for i in range(B)],
        colors=[rgb[i][new_mask[i]] for i in range(B)],
        features=[alpha_img[i][new_mask[i]] for i in range(B)],
    )
    return pointclouds.append_points(new_pc)
