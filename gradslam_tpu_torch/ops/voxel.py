"""Voxel-grid point merging (PyTorch port of gradslam_tpu.ops.voxel).

Merges points that fall into the same voxel cell into a single
confidence-weighted point: the arena's overflow policy that reclaims slots
from near-duplicate map points (``structures/maparena.voxel_compact_map``,
``slam/lifecycle.py``), complementing ccount-based eviction.

Every shape is static and the result is deterministic: rows are ordered by
cell with chained stable sorts, and each cell's sum is a segmented
log-shift scan, the JAX package's own adds in its own order. No float
atomics (``index_add_``, ``scatter_add``) are used: on a CUDA device they
sum in a different order from run to run, and a resumed run must equal an
uninterrupted one bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["voxel_merge_rows", "voxel_merge"]

_DEAD = 2**30  # the cell coordinate of a dead row: it sorts after every live cell


def _sort_by_voxel(pts, live, voxel_size, origin):
    """Sort permutation by voxel cell and the cell boundaries.

    Returns (perm, boundary): (B, N) ``perm`` orders each batch entry's rows
    by ``(vx, vy, vz, row)`` with dead rows last, and ``boundary[b, i]``
    marks the first row of each cell in sorted order.
    """
    # a true division, as the JAX package writes it. The divisor is a 0-d
    # tensor on the points' device: CUDA's division by a host scalar is a
    # multiply by its float32 reciprocal, which moves points near a cell
    # face into the next cell, so the card would merge other rows than the
    # CPU does
    size = torch.full((), voxel_size, dtype=pts.dtype, device=pts.device)
    v = torch.floor((pts - origin) / size).to(torch.int32)
    keys = [torch.where(live, v[..., c], _DEAD) for c in range(3)]
    # three stable sorts from the last key to the first give the
    # lexicographic (vx, vy, vz) order, equal cells in row order
    perm = None
    for key in reversed(keys):
        key = key if perm is None else key.gather(1, perm)
        step = torch.sort(key, dim=1, stable=True).indices
        perm = step if perm is None else perm.gather(1, step)
    sx, sy, sz = (k.gather(1, perm) for k in keys)
    same = (sx[:, 1:] == sx[:, :-1]) & (sy[:, 1:] == sy[:, :-1]) & (sz[:, 1:] == sz[:, :-1])
    boundary = torch.cat([torch.ones_like(same[:, :1]), ~same], dim=1)
    return perm, boundary


def _segmented_sum_at_ends(vals, boundary):
    """Inclusive segmented scan along dim 1 (the sum restarts at each
    ``boundary`` flag): each segment's total lands on its last row. A
    Hillis-Steele loop of ``ceil(log2 N)`` shifted adds, as the JAX package
    writes it."""
    N = vals.shape[1]
    scan, f = vals, boundary
    d = 1
    while d < N:
        shifted = torch.cat([torch.zeros_like(scan[:, :d]), scan[:, :-d]], dim=1)
        f_shifted = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        scan = scan + torch.where(f[..., None], 0.0, shifted)
        f = f | f_shifted
        d *= 2
    return scan


def voxel_merge_rows(
    rows: torch.Tensor,
    live: torch.Tensor,
    voxel_size: float,
    origin: Optional[torch.Tensor] = None,
    normalize_normals: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merges packed arena rows sharing a voxel into weighted averages.

    Args:
        rows: (B, N, C) packed rows with channels
            ``[points(0:3), normals(3:6), colors(6:9), ccounts(9:10), ...]``
            (structures/maparena.py layout).
        live: (B, N) bool mask of valid rows.
        voxel_size: cell edge length (same units as points).
        origin: optional (3,) grid origin (default 0).
        normalize_normals: re-normalize merged normals to unit length.

    Returns:
        (merged_rows, merged_live): (B, N, C) rows compacted to the front
        (one per occupied voxel, confidence-weighted: position/normal/color
        are ccount-weighted means, ccount is the cell sum; channels past 10
        are zero) and the (B, N) validity mask. Rows beyond the merged count
        are zero.
    """
    B, N, C = rows.shape
    dev = rows.device
    if origin is None:
        origin = torch.zeros((3,), dtype=rows.dtype, device=dev)
    live = live.bool()
    perm, boundary = _sort_by_voxel(rows[..., 0:3], live, voxel_size, origin)
    rs = rows.gather(1, perm[..., None].expand(B, N, C))  # a permutation: one writer per row
    ls = live.gather(1, perm)
    seg = torch.cumsum(boundary, dim=1, dtype=torch.int32) - 1

    cc = torch.where(ls, rs[..., 9], 0.0)[..., None]  # (B, N, 1) weights
    vals = torch.cat([rs[..., 0:9] * cc, cc], dim=-1)  # (B, N, 10)
    scan = _segmented_sum_at_ends(vals, boundary)

    # the last row of each cell, by one int32 scatter: every cell has one
    # last row, so each entry is written once (the dump column N takes the
    # rest); the dead tail's cell lands past the live cells and is masked
    rowix = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    last = torch.cat([boundary[:, 1:], torch.ones_like(boundary[:, :1])], dim=1)
    last_of_seg = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    last_of_seg = last_of_seg.scatter(1, torch.where(last, seg, N).long(), rowix)[:, :N]
    sums = scan.gather(1, last_of_seg.long()[..., None].expand(B, N, 10))
    wsum = sums[..., 9:10]
    denom = torch.where(wsum > 0, wsum, 1.0)
    attrs = sums[..., 0:9] / denom  # (B, N, 9) merged point/normal/color
    if normalize_normals:
        # the square root's input is guarded as well as the divide: at an
        # exactly zero normal (opposing normals cancelling in a cell) the
        # norm's backward is 0/0 otherwise, which would poison every
        # upstream gradient through the compaction
        nrm = attrs[..., 3:6]
        nsq = (nrm * nrm).sum(-1, keepdim=True)
        safe = nsq > 0
        nn = torch.sqrt(torch.where(safe, nsq, 1.0))
        attrs = torch.cat([attrs[..., 0:3], torch.where(safe, nrm / nn, nrm), attrs[..., 6:9]], dim=-1)

    n_cells = (boundary & ls).sum(dim=1, dtype=torch.int32)
    out_live = torch.arange(N, dtype=torch.int32, device=dev)[None, :] < n_cells[:, None]
    out = torch.cat([attrs, wsum, rows.new_zeros((B, N, C - 10))], dim=-1)
    # cells are contiguous at the front in sorted order (dead rows sort
    # last), so row i of the output is cell i directly
    return torch.where(out_live[..., None], out, 0.0), out_live


def voxel_merge(
    points: torch.Tensor,
    normals: torch.Tensor,
    colors: torch.Tensor,
    ccounts: torch.Tensor,
    live: torch.Tensor,
    voxel_size: float,
    origin: Optional[torch.Tensor] = None,
):
    """Attribute-array wrapper of :func:`voxel_merge_rows`.

    Args:
        points/normals/colors: (B, N, 3); ccounts: (B, N, 1); live: (B, N).

    Returns:
        (points, normals, colors, ccounts, live) with one row per occupied
        voxel, compacted to the front.
    """
    from ..structures.maparena import pack_rows

    rows = pack_rows(points, normals, colors, ccounts)
    merged, out_live = voxel_merge_rows(rows, live, voxel_size, origin)
    return (
        merged[..., 0:3],
        merged[..., 3:6],
        merged[..., 6:9],
        merged[..., 9:10],
        out_live,
    )
