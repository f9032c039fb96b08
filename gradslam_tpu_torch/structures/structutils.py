"""List <-> padded conversion helpers (PyTorch port of
gradslam_tpu.structures.structutils). On the device the padded form plus a
count is canonical; the list form is a host-boundary convenience."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["list_to_padded", "padded_to_list"]


def list_to_padded(
    x: Sequence[torch.Tensor],
    pad_size: Optional[Sequence[int]] = None,
    pad_value: float = 0.0,
    equisized: bool = False,
) -> torch.Tensor:
    """Stacks a list of B (N_b, C) tensors into (B, maxN, C) with padding.

    Args:
        x: list of 2D tensors (variable first dim), all on one device.
        pad_size: optional output (N, C); defaults to per-dim maxima.
        pad_value: fill value for padding.
        equisized: all inputs have the same shape — plain stack.
    """
    if equisized:
        return torch.stack(list(x))
    for t in x:
        if t.dim() != 2:
            raise ValueError("all items must be 2-dimensional")
    if pad_size is None:
        pad_dim0 = max((t.shape[0] for t in x), default=0)
        pad_dim1 = max((t.shape[1] for t in x), default=0)
    else:
        if len(pad_size) != 2:
            raise ValueError("pad_size must have length 2")
        pad_dim0, pad_dim1 = pad_size
        for t in x:
            if t.shape[0] > pad_dim0 or t.shape[1] > pad_dim1:
                raise ValueError(
                    f"pad_size {tuple(pad_size)} too small for input of "
                    f"shape {tuple(t.shape)}"
                )
    ref = x[0] if len(x) else torch.zeros(0)
    out = torch.full(
        (len(x), pad_dim0, pad_dim1), pad_value, dtype=ref.dtype, device=ref.device
    )
    for b, t in enumerate(x):
        out[b, : t.shape[0], : t.shape[1]] = t
    return out


def padded_to_list(
    x: torch.Tensor, split_size: Optional[Sequence[int]] = None
) -> List[torch.Tensor]:
    """Splits a (B, N, C) padded tensor into a list of (N_b, C) views.

    Args:
        split_size: per-element first-dim sizes; None keeps full rows.
    """
    if split_size is None:
        return [x[b] for b in range(x.shape[0])]
    if len(split_size) != x.shape[0]:
        raise ValueError(
            f"split_size length {len(split_size)} != batch size {x.shape[0]}"
        )
    return [x[b, : int(split_size[b])] for b in range(x.shape[0])]
