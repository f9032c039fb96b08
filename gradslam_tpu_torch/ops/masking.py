"""Masked compaction (PyTorch port of gradslam_tpu.ops.masking).

A static-shape replacement for ``nonzero`` / boolean indexing: it never
asks the host how many entries are selected, so it runs inside the frame
loop without a device sync.
"""

from __future__ import annotations

import torch

__all__ = ["compact_masked"]

METHODS = ("auto", "scatter", "sort")


def compact_masked(mask: torch.Tensor, out_size: int, method: str = "auto"):
    """Compacts the True positions of a (B, N) mask into a fixed-size buffer.

    Selected indices land in order at the front of a (B, out_size) buffer.
    When more than ``out_size`` entries are selected, the lowest-index ones
    win and the rest are dropped.

    Args:
        method: one of :data:`METHODS`, accepted for the JAX package's
            signature. Its 'scatter' and 'sort' give identical results, and
            this one implementation (a cumsum-addressed scatter) gives them
            too.

    Returns:
        (indices, valid): (B, out_size) int32 gather indices (0 where
        invalid) and (B, out_size) bool validity.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    B, N = mask.shape
    dev = mask.device
    mask = mask.bool()
    pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    # unselected and overflowing entries go to a dump column past the end
    slots = torch.where(mask & (pos < out_size), pos, out_size).long()
    src = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    buf = torch.zeros((B, out_size + 1), dtype=torch.int32, device=dev)
    buf = buf.scatter(1, slots, src)[:, :out_size]
    count = torch.clamp(mask.sum(dim=1), max=out_size)
    valid = torch.arange(out_size, device=dev)[None, :] < count[:, None]
    return buf, valid
