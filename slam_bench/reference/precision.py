"""The precision the reference computes in.

The configurations state float32 with TF32 off: the port writes every small
matrix product as a multiply-and-sum and every KNN distance as per-coordinate
differences, so no product runs on the tensor cores. The control of the
benchmark's comparison is this reference one step lower, as a later change
might be tempted to run it: the pose and projection products and the KNN's
``|s|^2 - 2 s.t + |t|^2`` form with their operands rounded to TF32 (10
mantissa bits, round to nearest, as the tensor cores convert float32),
summed in float32. The rounding is done here, so the control reads the same
on the CPU and on the card.
"""

from __future__ import annotations

import contextlib

import torch


class _State:
    tf32 = False


def lowered() -> bool:
    """True inside :func:`tf32_products`."""
    return _State.tf32


@contextlib.contextmanager
def tf32_products():
    """Runs the reference's products with TF32 operands (the control)."""
    before = _State.tf32
    _State.tf32 = True
    try:
        yield
    finally:
        _State.tf32 = before


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (nearest, ties away
    from zero); finite inputs only. The gradient passes through the
    rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded
