"""The mask scan's edge cases, shared by its CPU tests (the plain versions
against numpy, ``test_torch_ops.py``) and its card tests (the kernel against
the plain versions, ``test_torch_cuda.py``). Imports neither JAX nor a card."""

import numpy as np

# (B, N, out_size, share selected). A tile of the kernel is 8,192 entries.
MASK_EDGES = {
    "one row": (1, 1000, 300, 0.3),
    "N not a multiple of 16": (2, 8197, 5000, 0.5),
    "one past a tile": (3, 8193, 8193, 0.7),
    "all selected": (2, 20483, 20483, 1.0),
    "none selected": (2, 20483, 100, 0.0),
    "overflow": (3, 40000, 1000, 0.5),
    "out_size past N": (2, 777, 2000, 0.5),
    "out_size 0": (2, 777, 0, 0.5),
}


def mask_case(B, N, share, seed):
    """A (B, N) bool mask with about ``share`` selected, runs included, and
    (B,) int32 live counts, as numpy."""
    rng = np.random.default_rng(seed)
    mask = rng.random((B, N)) < share
    if 0 < share < 1 and N > 64:  # a run of selected entries and one of unselected ones
        mask[:, N // 4 : N // 4 + 64] = True
        mask[:, N // 2 : N // 2 + 64] = False
    return mask, rng.integers(0, 100_000, B).astype(np.int32)
