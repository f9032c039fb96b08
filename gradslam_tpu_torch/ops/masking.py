"""Masked compaction (PyTorch port of gradslam_tpu.ops.masking).

A static-shape replacement for ``nonzero`` / boolean indexing: it never
asks the host how many entries are selected, so it runs inside the frame
loop without a device sync.

Both functions here rest on one row scan of a (B, N) mask: the count of
selected entries up to each position. :func:`compact_masked` turns it into
compacted indices, :func:`append_slots` into the arena slots of appended
rows. On a CUDA tensor they launch the hand-written kernel in
``csrc/scan.cu`` (:data:`mask_scan_kernel`): a count of each tile of a row,
then a pass that places each tile's entries after the tiles before it, so
every row is spread over the whole card. On a CPU tensor they run their
plain versions, the cumsum forms :func:`compact_masked_reference` and
:func:`append_slots_reference`. There is no fallback between the two: a
CUDA input that the kernel does not take raises. The results are the same
integers on both.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary, check_inputs

__all__ = [
    "compact_masked",
    "compact_masked_reference",
    "append_slots",
    "append_slots_reference",
    "mask_scan_kernel",
]

METHODS = ("auto", "scatter", "sort")

# entries a block of the kernel takes (csrc/scan.cu): 512 threads, 16 each
_TILE = 8192


def compact_masked_reference(mask: torch.Tensor, out_size: int):
    """Plain-PyTorch :func:`compact_masked`: a cumsum-addressed scatter."""
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


def append_slots_reference(num_points: torch.Tensor, mask: torch.Tensor):
    """Plain-PyTorch :func:`append_slots`: ``num_points + cumsum(mask) - 1``."""
    mask = mask.bool()
    slots = num_points.to(torch.int32)[:, None] + torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    return slots, mask.sum(dim=1, dtype=torch.int32)


class _MaskScanKernel(CudaLibrary):
    """The CUDA kernel's wrapper: builds ``csrc/scan.cu`` at first use,
    checks its inputs, launches it on the current stream and counts its
    calls (one per compaction or append, each two kernel launches) in
    :attr:`launches`. Each call allocates its outputs and a (B, tiles) int32
    scratch of tile counts."""

    name = "mask_scan"
    source = "scan.cu"
    entries = {"gs_mask_scan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int] + [ctypes.c_void_p] * 5}

    def compact(self, mask: torch.Tensor, out_size: int):
        """(B, N) bool contiguous CUDA ``mask`` -> (idx (B, out_size) int32,
        0 past the count; count (B,) int32, the selected entries up to
        ``out_size``)."""
        B, N = self._check(mask)
        out_size = int(out_size)
        if out_size < 0 or B * out_size >= 2**31:
            raise ValueError(f"mask scan kernel: out_size {out_size} out of range for B={B}")
        idx = torch.zeros((B, out_size), dtype=torch.int32, device=mask.device)
        return idx, self._launch(mask, 0, out_size, idx, None, None)

    def slots(self, mask: torch.Tensor, num_points: torch.Tensor):
        """(B, N) bool contiguous CUDA ``mask`` and (B,) int32 ``num_points``
        on its device -> (slots (B, N) int32 ``num_points + cumsum(mask) -
        1``; count (B,) int32, the selected entries)."""
        B, N = self._check(mask, num_points)
        slots = torch.empty((B, N), dtype=torch.int32, device=mask.device)
        return slots, self._launch(mask, 1, 0, None, num_points, slots)

    @staticmethod
    def _check(mask: torch.Tensor, num_points=None):
        check_inputs("mask scan kernel", mask=(mask, torch.bool, ("B", "N")),
                     num_points=(num_points, torch.int32, ("B",)))
        B, N = mask.shape
        if B > 65535 or B * N >= 2**31:
            raise ValueError(f"mask scan kernel: sizes out of range (B={B}, N={N})")
        return B, N

    def _launch(self, mask, to_slots, out_size, idx, num_points, slots):
        """Fills ``idx`` or ``slots``; returns the (B,) int32 row counts,
        which the kernel's last tile of each row writes."""
        B, N = mask.shape
        if B * N == 0:
            return torch.zeros((B,), dtype=torch.int32, device=mask.device)
        count = torch.empty((B,), dtype=torch.int32, device=mask.device)
        counts = torch.empty((B, -(-N // _TILE)), dtype=torch.int32, device=mask.device)
        self.invoke("gs_mask_scan", mask.device, mask.data_ptr(), B, N, counts.data_ptr(), to_slots, out_size,
                    _ptr(idx), _ptr(num_points), _ptr(slots), count.data_ptr())
        return count


def _ptr(t):
    return None if t is None else t.data_ptr()


mask_scan_kernel = _MaskScanKernel()


def compact_masked(mask: torch.Tensor, out_size: int, method: str = "auto"):
    """Compacts the True positions of a (B, N) mask into a fixed-size buffer.

    Selected indices land in order at the front of a (B, out_size) buffer.
    When more than ``out_size`` entries are selected, the lowest-index ones
    win and the rest are dropped.

    Args:
        method: one of :data:`METHODS`, accepted for the JAX package's
            signature. Its 'scatter' and 'sort' give identical results, and
            so does this one function: the scan kernel on a CUDA mask,
            :func:`compact_masked_reference` on a CPU one.

    Returns:
        (indices, valid): (B, out_size) int32 gather indices (0 where
        invalid) and (B, out_size) bool validity.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if not mask.is_cuda:
        return compact_masked_reference(mask, out_size)
    idx, count = mask_scan_kernel.compact(mask.bool().contiguous(), out_size)
    valid = torch.arange(out_size, device=mask.device)[None, :] < count[:, None]
    return idx, valid


def append_slots(num_points: torch.Tensor, mask: torch.Tensor):
    """The arena slots of rows appended under a (B, N) mask.

    Selected rows land in order after the ``num_points`` (B,) int32 live
    rows: entry ``i`` of row ``b`` gets ``num_points[b] + cumsum(mask)[b, i]
    - 1``, selected or not (only a selected entry's slot is used).

    Returns:
        (slots, count): (B, N) int32 slots and (B,) int32 selected entries
        a row. The scan kernel on a CUDA mask, :func:`append_slots_reference`
        on a CPU one.
    """
    if not mask.is_cuda:
        return append_slots_reference(num_points, mask)
    return mask_scan_kernel.slots(mask.bool().contiguous(), num_points)
