"""A map arena partitioned by slot over the ranks of a process group.

Map rank ``m`` of ``n`` holds the global slots ``[m*CAP/n, (m+1)*CAP/n)`` of
every batch element as a local (B, CAP/n, 12) arena; ``num_points`` stays
global and is the same on every rank of the group. Nothing replicates the
arena: the frame step moves only per-frame buffers between the ranks.

Every cross-rank step is an ``all_reduce``:

  - an owner-placed SUM assembles rows or slots that one rank holds: each
    rank writes what it owns at its global position and zeros elsewhere.
    Floats are summed as their integer bits, so the owner's bits arrive
    exactly (a float sum would turn the owner's -0.0 into +0.0);
  - a MIN picks the fusion winner of each pixel across the group, one key
    word at a time (:meth:`MapShard.winner`).

With ``n == 1`` every collective is skipped and the shard is the arena.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..ops.masking import compact_masked
from ..ops.winner import _BITS
from ..structures.maparena import MapState, scatter_rows

__all__ = ["MapShard", "check_sharded_options", "owner_sum"]

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


def owner_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The owner-placed sum over ``group``, in place: ``x`` holds this
    rank's values at their global positions and zeros elsewhere, each
    position has one owner, and every rank gets the owners' bits (floats are
    summed as their integer bits)."""
    bits = x.view(_BITS[x.dtype]) if x.is_floating_point() else x
    dist.all_reduce(bits, group=group)
    return bits.view(x.dtype)


def check_sharded_options(opts, shard: "MapShard") -> None:
    """Raises ``ValueError`` for the options that map sharding does not run
    yet (ROADMAP item A14b): it runs the exact full-arena PointFusion path
    (``PointFusion()``'s mapping: fusion, KNN association, no window, no
    block gating, the fusion step's candidates reused by the odometry)."""
    from .fusionutils import _resolve_assoc_window

    bad = []
    if not opts.fusion:
        bad.append("aggregate mapping (fusion=False)")
    if opts.assoc != "knn":
        bad.append(f"assoc={opts.assoc!r}")
    if _resolve_assoc_window(opts.assoc_window, shard.capacity) is not None:
        bad.append(f"assoc_window={opts.assoc_window}")
    if opts.block_size is not None:
        bad.append(f"block_size={opts.block_size}")
    if opts.odom != "gt" and not opts.reuse_actives:
        bad.append("reuse_actives=False")
    if bad:
        raise ValueError(
            f"the map-sharded arena (map > 1) runs the exact full-arena fusion path only; "
            f"{', '.join(bad)} under map sharding is ROADMAP item A14b"
        )


@dataclass(frozen=True)
class MapShard:
    """This rank's part of a map arena partitioned over a process group.

    Attributes:
        group: the ``torch.distributed`` group of the map axis (None: the
            default group).
        rank: this rank's index in the group.
        n: the group's size.
        capacity: the global arena's rows (a multiple of ``n``).
    """

    group: Any
    rank: int
    n: int
    capacity: int

    def __post_init__(self):
        if self.capacity % self.n:
            raise ValueError(f"arena capacity {self.capacity} is not a multiple of the map axis {self.n}")

    @property
    def rows(self) -> int:
        """Rows of the local arena: ``capacity / n``."""
        return self.capacity // self.n

    @property
    def offset(self) -> int:
        """The global slot of the local arena's row 0."""
        return self.rank * self.rows

    def owns(self, slots: torch.Tensor) -> torch.Tensor:
        """Whether each global slot lies in this rank's range."""
        return (slots >= self.offset) & (slots < self.offset + self.rows)

    def local(self, slots: torch.Tensor) -> torch.Tensor:
        """Global slots as local rows, clamped into the local arena."""
        return torch.clamp(slots - self.offset, 0, self.rows - 1)

    def live(self, state: MapState) -> torch.Tensor:
        """(B, rows) mask of the live local rows."""
        idx = self.offset + torch.arange(self.rows, dtype=torch.int32, device=state.data.device)
        return idx[None, :] < state.num_points[:, None]

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place ``all_reduce`` over the group (nothing when n == 1)."""
        if self.n > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def assemble(self, x: torch.Tensor, owned: torch.Tensor) -> torch.Tensor:
        """The owner's value of ``x`` on every rank: ``x`` where ``owned``
        (broadcast against it), zero elsewhere, summed over the group as
        integer bits. Each position must have exactly one owner."""
        x = torch.where(owned, x, torch.zeros_like(x))
        return owner_sum(x, self.group) if self.n > 1 else x

    def gather_rows(self, data: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        """Rows at global ``slots`` (B, M) of the arena whose local part is
        ``data`` (B, rows, C): (B, M, C), the same on every rank."""
        idx = self.local(slots).long()[..., None].expand(-1, -1, data.shape[-1])
        return self.assemble(torch.gather(data, 1, idx), self.owns(slots)[..., None])

    def compact(self, mask: torch.Tensor, out_size: int):
        """:func:`~gradslam_tpu_torch.ops.masking.compact_masked` of the global
        arena's (B, CAP) mask, from this rank's (B, rows) part of it.

        The global list is the ranks' lists joined in rank order (their slots
        ascend with the rank), cut at ``out_size``.

        Returns:
            (idx, keep, slots, valid): this rank's part of the list, ``idx``
            (B, K) local rows with ``keep`` (B, K) marking those inside the
            cut (a prefix), and the whole list on every rank, ``slots``
            (B, out_size) int32 global slots (0 where invalid) and ``valid``
            (B, out_size), as ``compact_masked`` returns them on one device.
        """
        B = mask.shape[0]
        dev = mask.device
        K = min(out_size, self.rows)
        idx, valid = compact_masked(mask, K)
        counts = torch.zeros((B, self.n), dtype=torch.int32, device=dev)
        counts[:, self.rank] = mask.sum(dim=1, dtype=torch.int32)
        self.all_reduce(counts)
        before = counts[:, : self.rank].sum(dim=1, dtype=torch.int32)
        pos = before[:, None] + torch.arange(K, dtype=torch.int32, device=dev)[None, :]
        keep = valid & (pos < out_size)
        buf = torch.zeros((B, out_size + 1), dtype=torch.int32, device=dev)
        buf = buf.scatter(1, torch.where(keep, pos, out_size).long(), idx + self.offset)[:, :out_size]
        self.all_reduce(buf)
        total = torch.clamp(counts.sum(dim=1), max=out_size)
        return idx, keep, buf, torch.arange(out_size, device=dev)[None, :] < total[:, None]

    def winner(self, wslots: torch.Tensor, sorted_slots: torch.Tensor, k_hi: torch.Tensor,
               k_lo: torch.Tensor) -> torch.Tensor:
        """The fusion winner of each pixel across the group.

        ``wslots`` (B, P) is this rank's winner (global slot, ``capacity``
        where none) among its candidates, whose global slots
        ``sorted_slots`` (B, K) ascend (``capacity`` past the last one) and
        whose priority words are ``k_hi``, ``k_lo`` (B, K), compared as
        unsigned. The group's winner is the least ``(k_hi, k_lo, slot)``:
        three ``all_reduce`` MIN rounds, on ``k_hi``, then on ``k_lo`` among
        the ranks that hold the least ``k_hi``, then on the slot among those
        that hold both. Returns (B, P) int32 global slots, the same on every
        rank.
        """
        if self.n == 1:
            return wslots
        has = wslots < self.capacity
        pos = torch.clamp(torch.searchsorted(sorted_slots, wslots.contiguous()), max=sorted_slots.shape[1] - 1)
        # unsigned order as signed order: flip the sign bit
        hi = torch.where(has, k_hi.gather(1, pos) ^ INT32_MIN, INT32_MAX)
        lo = torch.where(has, k_lo.gather(1, pos) ^ INT32_MIN, INT32_MAX)
        best_hi = self.all_reduce(hi.clone(), dist.ReduceOp.MIN)
        has = has & (hi == best_hi)
        best_lo = self.all_reduce(torch.where(has, lo, INT32_MAX), dist.ReduceOp.MIN)
        has = has & (lo == best_lo)
        return self.all_reduce(torch.where(has, wslots, self.capacity), dist.ReduceOp.MIN)

    def append_rows(self, state: MapState, new_rows: torch.Tensor, new_mask: torch.Tensor) -> MapState:
        """:func:`~gradslam_tpu_torch.structures.maparena.append_rows_to_map`
        on the global arena: the selected rows go, in order, to the global
        slots ``num_points + cumsum(mask) - 1`` below ``capacity``; this rank
        writes those in its range."""
        new_mask = new_mask.bool()
        mask_i = new_mask.to(torch.int32)
        slots = state.num_points.long()[:, None] + torch.cumsum(mask_i, dim=1) - 1
        keep = new_mask & (slots < self.capacity) & self.owns(slots)
        data = scatter_rows(state.data, self.local(slots), new_rows, keep)
        n_added = mask_i.sum(dim=1, dtype=torch.int32)
        return MapState(data=data, num_points=torch.clamp(state.num_points + n_added, max=self.capacity))
