"""A map arena partitioned by slot over the ranks of a process group.

Map rank ``m`` of ``n`` holds the global slots ``[m*CAP/n, (m+1)*CAP/n)`` of
every batch element as a local (B, CAP/n, 12) arena; ``num_points`` stays
global and is the same on every rank of the group. Nothing replicates the
arena: the frame step moves only per-frame buffers between the ranks.

Every cross-rank step is an ``all_reduce``:

  - an owner-placed SUM assembles rows or slots that one rank holds: each
    rank writes what it owns at its global position and zeros elsewhere.
    Floats are summed as their integer bits, so the owner's bits arrive
    exactly (a float sum would turn the owner's -0.0 into +0.0). Its
    gradient is the SUM of the ranks' cotangents (:class:`_OwnerSum`);
  - a MIN picks the fusion winner of each pixel across the group, one key
    word at a time (:meth:`MapShard.winner`);
  - a SUM of counts places each rank's part of a compacted list
    (:meth:`MapShard.compact`).

Every rank takes every collective in the same order: no branch on local
data skips one. With ``n == 1`` (:meth:`MapShard.whole`) every collective is
skipped and the shard is the arena: one process runs the same code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ops.masking import compact_masked
from ..ops.winner import _BITS
from ..structures.maparena import MapState, scatter_rows

__all__ = ["MapShard", "owner_sum"]

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


class _OwnerSum(torch.autograd.Function):
    """The owner-placed sum with a gradient.

    Forward: the integer-bit sum, so every rank gets the owners' bits.
    Backward: the SUM of the ranks' cotangents (as
    ``torch.distributed.nn.functional.all_reduce``), which routes the
    gradient of every rank's copy to the owner. Each rank then holds the
    gradient of the sum of the ranks' losses with respect to its own
    inputs: a replicated loss is counted once per rank, which the caller
    divides out (:func:`~gradslam_tpu_torch.parallel.sharded.sharded_train_step`).
    """

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out.view(_BITS[x.dtype]) if x.is_floating_point() else out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def owner_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The owner-placed sum over ``group``: ``x`` holds this rank's values at
    their global positions and zeros elsewhere, each position has one owner,
    and every rank gets the owners' bits (floats are summed as their integer
    bits); differentiable (:class:`_OwnerSum`)."""
    return _OwnerSum.apply(x, group)


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

    @classmethod
    def whole(cls, capacity: int) -> "MapShard":
        """The whole arena on one process: a group of one, no collective."""
        return cls(None, 0, 1, capacity)

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

    def slots(self, n: int, device) -> torch.Tensor:
        """(n,) int32 global slots of the local rows ``[0, n)``."""
        return self.offset + torch.arange(n, dtype=torch.int32, device=device)

    def live(self, state: MapState) -> torch.Tensor:
        """(B, rows) mask of the live local rows."""
        return self.window(state)[1]

    def window(self, state: MapState, win: Optional[int] = None):
        """This rank's rows of the global prefix ``[0, win)`` (None: the
        whole shard) and their live mask: (B, n, C) and (B, n) bool. ``n`` is
        at least 1: a rank that holds none of the prefix keeps one masked
        row, so it still runs every step and every collective."""
        n = self.rows if win is None else max(1, min(self.rows, win - self.offset))
        slots = self.slots(n, state.data.device)[None, :]
        live = slots < state.num_points[:, None]
        return state.data[:, :n], live if win is None else live & (slots < win)

    def assemble_prefix(self, x: torch.Tensor, total: int) -> torch.Tensor:
        """The global (B, total, ...) prefix from every rank's local rows:
        ``x`` (B, n, ...) holds this rank's rows ``[0, n)``, of which those
        below global slot ``total`` are placed; one owner-placed sum."""
        if x.dtype == torch.bool:
            return self.assemble_prefix(x.to(torch.int32), total).bool()
        out = x.new_zeros((x.shape[0], total) + x.shape[2:])
        m = max(0, min(x.shape[1], total - self.offset))
        out[:, self.offset : self.offset + m] = x[:, :m]
        return self.assemble(out)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place ``all_reduce`` over the group (nothing when n == 1)."""
        if self.n > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def assemble(self, x: torch.Tensor, owned: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The owner's value of ``x`` on every rank: ``x`` where ``owned``
        (broadcast against it; None: ``x`` is zero where this rank does not
        own it), zero elsewhere, summed over the group as integer bits. Each
        position must have exactly one owner."""
        if owned is not None:
            x = torch.where(owned, x, torch.zeros_like(x))
        return owner_sum(x, self.group) if self.n > 1 else x

    def gather_rows(self, data: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        """Rows at global ``slots`` (B, M) of the arena whose local part is
        ``data`` (B, rows, C): (B, M, C), the same on every rank."""
        idx = self.local(slots).long()[..., None].expand(-1, -1, data.shape[-1])
        return self.assemble(torch.gather(data, 1, idx), self.owns(slots)[..., None])

    def compact(self, mask: torch.Tensor, out_size: int, slots: Optional[torch.Tensor] = None):
        """:func:`~gradslam_tpu_torch.ops.masking.compact_masked` of the global
        arena's (B, CAP) mask, from this rank's (B, n) part of it: the mask of
        its rows at the global ``slots`` (B, n) int32, ascending (None: the
        local rows ``[0, n)``), and False on every other slot the rank holds.

        The global list is the ranks' lists joined in rank order (their slots
        ascend with the rank), cut at ``out_size``.

        Returns:
            (idx, keep, slots, valid): this rank's part of the list, ``idx``
            (B, K) positions in ``mask`` with ``keep`` (B, K) marking those
            inside the cut (a prefix), and the whole list on every rank,
            ``slots`` (B, out_size) int32 global slots (0 where invalid) and
            ``valid`` (B, out_size), as ``compact_masked`` returns them on
            one device. ``K`` is ``min(out_size, n)``, and ``out_size`` in a
            group of one, where this is one ``compact_masked``.
        """
        if self.n == 1:
            idx, valid = compact_masked(mask, out_size)
            src = idx if slots is None else torch.where(valid, slots.gather(1, idx.long()), 0)
            return idx, valid, src, valid
        B = mask.shape[0]
        dev = mask.device
        K = min(out_size, mask.shape[1])
        idx, valid = compact_masked(mask, K)
        counts = torch.zeros((B, self.n), dtype=torch.int32, device=dev)
        counts[:, self.rank] = mask.sum(dim=1, dtype=torch.int32)
        self.all_reduce(counts)
        before = counts[:, : self.rank].sum(dim=1, dtype=torch.int32)
        pos = before[:, None] + torch.arange(K, dtype=torch.int32, device=dev)[None, :]
        keep = valid & (pos < out_size)
        buf = torch.zeros((B, out_size + 1), dtype=torch.int32, device=dev)
        src = idx + self.offset if slots is None else slots.gather(1, idx.long())
        buf = buf.scatter(1, torch.where(keep, pos, out_size).long(), src)[:, :out_size]
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
        sorted_slots = sorted_slots.contiguous()
        pos = torch.clamp(torch.searchsorted(sorted_slots, wslots.contiguous()), max=sorted_slots.shape[1] - 1)
        # unsigned order as signed order: flip the sign bit
        hi = torch.where(has, k_hi.gather(1, pos) ^ INT32_MIN, INT32_MAX)
        lo = torch.where(has, k_lo.gather(1, pos) ^ INT32_MIN, INT32_MAX)
        best_hi = self.all_reduce(hi.clone(), dist.ReduceOp.MIN)
        has = has & (hi == best_hi)
        best_lo = self.all_reduce(torch.where(has, lo, INT32_MAX), dist.ReduceOp.MIN)
        has = has & (lo == best_lo)
        return self.all_reduce(torch.where(has, wslots, self.capacity), dist.ReduceOp.MIN)

    def append_rows(self, state: MapState, new_rows: torch.Tensor, new_mask: torch.Tensor, appended) -> MapState:
        """:func:`~gradslam_tpu_torch.structures.maparena.append_rows_to_map`
        on the global arena: the selected rows go, in order, to the global
        slots ``num_points + cumsum(mask) - 1`` below ``capacity``; this rank
        writes those in its range. ``appended`` is
        ``append_slots(state.num_points, new_mask)``: the slots and the
        count, which the caller computes and may use again."""
        new_mask = new_mask.bool()
        slots, n_added = appended
        keep = new_mask & (slots < self.capacity) & self.owns(slots)
        data = scatter_rows(state.data, self.local(slots), new_rows, keep)
        return MapState(data=data, num_points=torch.clamp(state.num_points + n_added, max=self.capacity))
