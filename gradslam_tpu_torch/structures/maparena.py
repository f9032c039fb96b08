"""Fixed-capacity global map arena (PyTorch port of gradslam_tpu.structures.maparena).

The map is a preallocated (B, CAP, 12) arena of packed rows
``[points(0:3), normals(3:6), colors(6:9), ccounts(9), label(10),
label_conf(11)]`` plus a live count per batch element. "Append" is a
masked scatter at ``count + cumsum(mask) - 1``, so every shape stays static
and nothing waits on the host. Functions return new tensors (the scatters
are out of place); the copy costs one pass over the arena.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "MapState",
    "pack_rows",
    "init_map",
    "map_mask",
    "append_rows_to_map",
    "append_to_map",
    "compact_map",
    "map_to_pointclouds",
    "map_state_from_numpy",
    "map_state_to_numpy",
]

_CH = 12  # packed row width


@dataclass
class MapState:
    """A batch of fixed-capacity packed point arenas.

    Attributes:
        data: (B, CAP, 12) packed rows.
        num_points: (B,) int32 live count per batch element.
    """

    data: torch.Tensor
    num_points: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def points(self) -> torch.Tensor:
        return self.data[..., 0:3]

    @property
    def normals(self) -> torch.Tensor:
        return self.data[..., 3:6]

    @property
    def colors(self) -> torch.Tensor:
        return self.data[..., 6:9]

    @property
    def ccounts(self) -> torch.Tensor:
        return self.data[..., 9:10]

    @property
    def labels(self) -> torch.Tensor:
        return self.data[..., 10]

    @property
    def label_conf(self) -> torch.Tensor:
        return self.data[..., 11]


def pack_rows(points, normals, colors, ccounts) -> torch.Tensor:
    """Packs (..., 3/3/3/1) attributes into (..., 12) arena rows."""
    pad = points.new_zeros(points.shape[:-1] + (_CH - 10,))
    return torch.cat([points, normals, colors, ccounts, pad], dim=-1)


def init_map(batch_size: int, capacity: int, dtype=torch.float32, device=None) -> MapState:
    """An empty arena on ``device`` (default ``"cuda"``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    return MapState(
        data=torch.zeros((batch_size, capacity, _CH), dtype=dtype, device=dev),
        num_points=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )


def map_mask(state: MapState) -> torch.Tensor:
    """(B, CAP) bool mask of live map slots."""
    idx = torch.arange(state.capacity, dtype=torch.int32, device=state.data.device)
    return idx[None, :] < state.num_points[:, None]


def scatter_rows(data, slots, rows, keep) -> torch.Tensor:
    """Out-of-place row scatter ``data[b, slots[b, m]] = rows[b, m]`` where
    ``keep``; the other rows are dropped (their slots may be out of range).

    A dropped row is redirected to the first kept row's slot with that
    row's value, or, in a batch element with no kept row, to slot 0 with
    its current value: duplicates then write identical bits, so the result
    is deterministic without a spare dump row in the arena.

    Gradient: each slot's output gradient flows back once, as for the
    JAX package's ``.at[].set(mode='drop')``: a kept row gets its slot's,
    a dropped row none, ``data`` the gradient of every slot no kept row
    writes. ``torch.scatter`` hands each duplicate writer the whole output
    gradient of its slot, so only one writer of the fallback slot carries
    it (the first kept row, or row 0 where none is kept); the copies the
    other writers hold are detached.
    """
    B, M, C = rows.shape
    if M == 0:
        return data
    first = torch.argmax(keep.to(torch.int32), dim=1)[:, None]  # (B, 1)
    any_keep = keep.any(dim=1, keepdim=True)
    slots = slots.long()
    fb_slot = torch.where(any_keep, slots.gather(1, first), torch.zeros_like(first))
    fb_row = torch.where(
        any_keep[..., None],
        rows.gather(1, first[..., None].expand(B, 1, C)),
        data[:, :1],
    )
    lead = keep.scatter(1, first, True)  # the fallback slot's one live writer
    idx = torch.where(keep, slots, fb_slot)
    val = torch.where(keep[..., None], rows, torch.where(lead[..., None], fb_row, fb_row.detach()))
    return data.scatter(1, idx[..., None].expand(B, M, C), val)


def append_rows_to_map(
    state: MapState, new_rows: torch.Tensor, new_mask: torch.Tensor
) -> MapState:
    """Appends packed (B, M, 12) candidate rows under a (B, M) mask.

    Selected rows land in order at slots ``num_points + cumsum(mask) - 1``;
    rows beyond capacity are dropped.
    """
    cap = state.capacity
    new_mask = new_mask.bool()
    mask_i = new_mask.to(torch.int32)
    slots = state.num_points.long()[:, None] + torch.cumsum(mask_i, dim=1) - 1
    data = scatter_rows(state.data, slots, new_rows, new_mask & (slots < cap))
    n_added = mask_i.sum(dim=1, dtype=torch.int32)
    return MapState(data=data, num_points=torch.clamp(state.num_points + n_added, max=cap))


def append_to_map(state, new_points, new_normals, new_colors, new_ccounts, new_mask):
    """Appends masked candidate points to the arena (static shapes)."""
    rows = pack_rows(new_points, new_normals, new_colors, new_ccounts)
    return append_rows_to_map(state, rows, new_mask)


def compact_map(state: MapState, min_ccount: float = 0.0, keep_recent: int = 0) -> MapState:
    """Defragments the arena, evicting points with ``ccounts < min_ccount``
    except the ``keep_recent`` most recently appended; survivors keep their
    order at the front of the arena."""
    from ..ops.masking import compact_masked

    cap = state.capacity
    live = map_mask(state)
    idx = torch.arange(cap, dtype=torch.int32, device=state.data.device)[None, :]
    recent = idx >= (state.num_points[:, None] - keep_recent)
    keep = live & ((state.ccounts[..., 0] >= min_ccount) | recent)
    take_idx, valid = compact_masked(keep, cap)
    data = state.data.gather(1, take_idx.long()[..., None].expand(-1, -1, _CH))
    data = data * valid[..., None].to(data.dtype)
    return MapState(data=data, num_points=keep.sum(dim=1, dtype=torch.int32))


def map_to_pointclouds(state: MapState):
    """The arena as a user-facing :class:`Pointclouds`."""
    from .pointclouds import Pointclouds

    return Pointclouds._from_padded(
        state.points, state.normals, state.colors, state.ccounts, state.num_points
    )


def map_state_from_numpy(data, num_points, device=None) -> MapState:
    """A :class:`MapState` from the JAX package's ``MapState`` fields as
    numpy arrays: ``data`` (B, CAP, 12) and ``num_points`` (B,)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    return MapState(
        data=torch.tensor(np.asarray(data, dtype=np.float32), device=dev),
        num_points=torch.tensor(np.asarray(num_points, dtype=np.int32), device=dev),
    )


def map_state_to_numpy(state: MapState):
    """``(data, num_points)`` as numpy arrays: the inverse of
    :func:`map_state_from_numpy`."""
    return state.data.detach().cpu().numpy(), state.num_points.cpu().numpy()
