"""Per-pixel fusion winner selection.

Every fusion step keeps one map row per pixel: among the candidate rows
that project to a pixel and pass the gates, the one with the largest
confidence count, then the smallest ray distance, then the smallest slot
(the reference's ``torch.unique`` row sort). The JAX package picks it with a
4-key ``lax.sort``; its bucket form, a read-modify-write min into a per-pixel
table, is ``tools/diag_winner_radix.py::pallas_rmw``, which Mosaic never
lowered on the TPU.

On a CUDA tensor :func:`pixel_winner` launches the hand-written Hopper
kernel in ``csrc/winner.cu``: one cooperative launch a selection, two folds
(a 64-bit ``atomicMin`` of the key into a per-pixel table, then a 32-bit one
of the slot among the key's ties) with one grid barrier between them, and
no memset: the wrapper keeps two all-ones tables a stream, and each call
resets the one the call before it used. That schedule lives on the host, so
a call made while its stream is captured into a CUDA graph takes a table of
its own instead, allocated in the graph and filled with ones by the graph
before the kernel at every replay (:meth:`_WinnerKernel.tables`). On a CPU
tensor it runs
:func:`pixel_winner_reference`, the sort form of the same function. There is
no fallback between the two: a CUDA input that the kernel does not take
raises. The result is exact on both.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary, check_inputs

__all__ = [
    "winner_keys",
    "winner_order_keys",
    "pixel_winner",
    "pixel_winner_reference",
    "winner_kernel",
]

_INT32_MIN = -(2**31)
# the integer type of a float's bits
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """Maps float32 (float64) to int32 (int64) keys in the same signed
    order (-0.0 equal to 0.0)."""
    bits = (x + 0.0).view(_BITS[x.dtype])
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def winner_keys(ccount: torch.Tensor, ray: torch.Tensor):
    """The fusion priority as two words in unsigned order.

    ``k_hi`` is the image of ``-ccount`` and ``k_lo`` that of ``ray``: for
    float inputs (no NaN), comparing the words as unsigned integers orders
    them as the floats, with ``-0.0`` equal to ``0.0``.

    Returns:
        (k_hi, k_lo): tensors of the inputs' shape, int32 words for float32
        inputs, int64 words for float64 ones. Only the plain version takes
        int64 words (the kernel raises): float64 runs on the CPU, as the
        JAX package's exact path sorts float64 keys under ``jax_enable_x64``.
    """
    lo = torch.iinfo(_BITS[ray.dtype]).min
    return _ordered_bits(-ccount) ^ lo, _ordered_bits(ray) ^ lo


def _u32(k: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their unsigned value as int64."""
    return k.to(torch.int64) & 0xFFFFFFFF


def winner_order_keys(pix, k_hi, k_lo, slot):
    """Permutation sorting (B, N) rows by ``(pix, k_hi, k_lo, slot)``
    ascending, the keys compared as unsigned words.

    The JAX package does this with one 4-key ``lax.sort``. Here the keys are
    packed into two int64 words, ``(pix, k_hi)`` and ``(k_lo, slot)``, and two
    stable sorts run from the last word to the first, which gives the same
    lexicographic order. ``pix`` and ``slot`` lie in ``[0, 2^31)``. Int64
    priority words (float64 keys) take one stable sort per key.
    """
    if k_hi.dtype == torch.int64:
        lo = torch.iinfo(torch.int64).min
        order = None
        for key in (slot.to(torch.int64), k_lo ^ lo, k_hi ^ lo, pix.to(torch.int64)):
            key = key if order is None else torch.gather(key, 1, order)
            step = torch.sort(key, dim=1, stable=True).indices
            order = step if order is None else torch.gather(order, 1, step)
        return order
    hi = (pix.to(torch.int64) << 32) | _u32(k_hi)
    lo = ((k_lo ^ _INT32_MIN).to(torch.int64) << 32) | slot.to(torch.int64)
    order = torch.sort(lo, dim=1, stable=True).indices
    return torch.gather(order, 1, torch.sort(torch.gather(hi, 1, order), dim=1, stable=True).indices)


def pixel_winner_reference(pix, k_hi, k_lo, slot, num_pixels: int, sentinel: int):
    """Plain-PyTorch winner per pixel: the sort form of :func:`pixel_winner`.

    Sorts the candidates by ``(pix, k_hi, k_lo, slot)``, keeps the first of
    each pixel's run and scatters its slot into a per-pixel table.
    """
    B = pix.shape[0]
    P = num_pixels
    pix = torch.where((pix >= 0) & (pix < P), pix, P)
    table = torch.full((B, P + 1), sentinel, dtype=torch.int32, device=pix.device)
    order = winner_order_keys(pix, k_hi, k_lo, slot)
    pix_sorted = torch.gather(pix, 1, order)
    slot_sorted = torch.gather(slot.to(torch.int32), 1, order)
    first = torch.ones_like(pix_sorted, dtype=torch.bool)
    first[:, 1:] = pix_sorted[:, 1:] != pix_sorted[:, :-1]
    dest = torch.where(first & (pix_sorted < P), pix_sorted, P).long()
    return table.scatter(1, dest, slot_sorted)[:, :P]


# the kernel's fixed sizes (csrc/winner.cu): threads a block, candidates a
# thread keeps in registers between the folds
_THREADS = 512
_KEEP = 2


class _Tables:
    """The two per-pixel key tables of one stream, all ones between uses.

    A call folds into the clean one (:meth:`take`) and resets the ``n``
    entries of the other that the call before it left dirty; :meth:`done`
    then records that the table it folded into holds ``n`` dirty entries and
    swaps the two. Calls on one stream run in order, so a table is never
    reset while a call still reads it.
    """

    def __init__(self):
        self.tables = [None, None]
        self.dirty = [0, 0]
        self.cur = 0

    def take(self, n: int, device):
        """(clean table of at least n entries, other table, its dirty count)."""
        c = self.cur
        if self.tables[c] is None or self.tables[c].numel() < n:
            self.tables[c] = torch.full((n,), -1, dtype=torch.int64, device=device)
        other = self.tables[1 - c]
        if other is None:
            return self.tables[c], self.tables[c], 0
        return self.tables[c], other, self.dirty[1 - c]

    def done(self, n: int):
        c = self.cur
        self.dirty[c], self.dirty[1 - c] = n, 0
        self.cur = 1 - c


class _WinnerKernel(CudaLibrary):
    """The CUDA kernel's wrapper: builds ``csrc/winner.cu`` at first use,
    checks its inputs, launches it on the current stream and counts its
    launches (one per selection) in :attr:`launches`. Each call allocates
    only its output; the key tables, two a stream, are kept across calls."""

    name = "winner"
    source = "winner.cu"
    entries = {
        "gst_pixel_winner": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        "gst_pixel_winner_max_blocks": [ctypes.POINTER(ctypes.c_int)],
    }

    def __init__(self):
        super().__init__()
        self._max_blocks = {}
        self._tables = {}

    def max_blocks(self) -> int:
        """The most blocks the current device holds at once: a cooperative
        launch takes no more."""
        dev = torch.cuda.current_device()
        if dev not in self._max_blocks:
            n = ctypes.c_int(0)
            err = self.load()["gst_pixel_winner_max_blocks"](ctypes.byref(n))
            if err != 0 or n.value < 1:
                raise RuntimeError(f"winner kernel: occupancy query failed: cudaError {err}")
            self._max_blocks[dev] = n.value
        return self._max_blocks[dev]

    @staticmethod
    def grid(B: int, N: int, P: int, max_blocks: int) -> int:
        """Blocks for a call's shapes, chosen on the card with
        ``tools/winner_tiles.py``: enough that every thread keeps at most
        ``_KEEP`` candidates and fills at most 4 output pixels, and no more
        than the card holds at once."""
        need = max(-(-B * N // (_THREADS * _KEEP)), -(-B * P // (_THREADS * 4)), 1)
        return min(max_blocks, need)

    def __call__(self, pix, k_hi, k_lo, slot, num_pixels: int, sentinel: int):
        """(B, N) int32 contiguous CUDA tensors on one device ->
        (B, num_pixels) int32 winner slots."""
        return self.launch(pix, k_hi, k_lo, slot, num_pixels, sentinel)

    def launch(self, pix, k_hi, k_lo, slot, num_pixels: int, sentinel: int, blocks=None):
        """One launch; ``blocks`` overrides :meth:`grid`'s choice."""
        spec = torch.int32, ("B", "N")
        check_inputs("winner kernel", pix=(pix, *spec), k_hi=(k_hi, *spec), k_lo=(k_lo, *spec), slot=(slot, *spec))
        dev = pix.device
        B, N = pix.shape
        P = int(num_pixels)
        if P < 0 or B * max(N, P) >= 2**31 or not -(2**31) <= sentinel < 2**31:
            raise ValueError(f"winner kernel: sizes out of range (B={B}, N={N}, P={P})")
        out = torch.empty((B, P), dtype=torch.int32, device=dev)
        if B * P == 0:
            return out
        with torch.cuda.device(dev):
            most = self.max_blocks()
            blocks = self.grid(B, N, P, most) if blocks is None else int(blocks)
            if not 1 <= blocks <= most:
                raise ValueError(f"winner kernel: {blocks} blocks, the card holds 1 to {most}")
            stream = torch.cuda.current_stream().cuda_stream
            best, other, n_other, fill, done = self.tables(B * P, dev, stream,
                                                           torch.cuda.is_current_stream_capturing())
            if fill:
                best.fill_(-1)
            try:
                self.invoke("gst_pixel_winner", dev, pix.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(),
                            slot.data_ptr(), best.data_ptr(), other.data_ptr(), n_other, out.data_ptr(), B, N, P,
                            int(sentinel), blocks)
            except RuntimeError:
                # whatever the error, the next call on the stream starts from
                # fresh all-ones tables
                self._tables.pop((dev.index, stream), None)
                raise
        done()
        return out

    def tables(self, n: int, device, stream, capturing: bool):
        """The key tables of one call of ``n`` table entries on ``stream``:
        ``(best, other, n_other, fill, done)``. The kernel folds into
        ``best``, which must hold all ones, and resets the first ``n_other``
        entries of ``other``; the caller fills ``best`` with ones first when
        ``fill`` is true and calls ``done()`` after a launch.

        Eagerly the stream's two tables alternate (:class:`_Tables`). A
        captured call is replayed without this host code, so it takes a
        table of its own, allocated in the graph's pool and filled by the
        graph before the kernel at every replay: every replay folds into a
        clean table, whatever ran before it.
        """
        if capturing:
            best = torch.empty((n,), dtype=torch.int64, device=device)
            return best, best, 0, True, lambda: None
        tables = self._tables.setdefault((device.index, stream), _Tables())
        best, other, n_other = tables.take(n, device)
        return best, other, n_other, False, lambda: tables.done(n)


winner_kernel = _WinnerKernel()


def pixel_winner(pix, k_hi, k_lo, slot, num_pixels: int, sentinel: int) -> torch.Tensor:
    """The winning candidate's slot per pixel.

    Args:
        pix: (B, N) int32 pixel of each candidate; outside
            ``[0, num_pixels)`` it never wins.
        k_hi, k_lo: (B, N) int32 priority words, compared as unsigned
            (:func:`winner_keys` builds them from the fusion's ccount and ray
            distance).
        slot: (B, N) int32 in ``[0, sentinel)``: the value returned for a
            winner, and the last tie-break.
        num_pixels: P.
        sentinel: the value where a pixel has no candidate.

    Returns:
        (B, P) int32: the ``slot`` of the candidate with the smallest
        ``(k_hi, k_lo, slot)`` at each pixel, ``sentinel`` where none. A CUDA
        ``pix`` runs the Hopper kernel; a CPU one runs
        :func:`pixel_winner_reference`.
    """
    if pix.is_cuda:
        return winner_kernel(
            *(t.contiguous() for t in (pix, k_hi, k_lo, slot)), num_pixels, sentinel
        )
    return pixel_winner_reference(pix, k_hi, k_lo, slot, num_pixels, sentinel)
