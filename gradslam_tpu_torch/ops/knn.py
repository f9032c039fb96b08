"""Exact 1-nearest-neighbour (PyTorch port of gradslam_tpu.ops.knn).

The data-association core of every ICP iteration. On a CUDA tensor
:func:`knn` launches the hand-written Hopper kernel in ``csrc/knn.cu``; on
a CPU tensor it runs :func:`knn_reference`, the plain version of the same
function. There is no fallback between the two: a CUDA input that the
kernel does not take raises.

Distances are exact float32 per-coordinate differences
``(dx*dx + dy*dy) + dz*dz``, never the ``|s|^2 - 2 s.t + |t|^2`` matmul
form (its cancellation rounding flips near-tie neighbours). Invalid
targets never win; ties go to the lowest target index; with no valid
target the result is ``(inf, 0)``. Both outputs are detached: gradients
flow through gathers of the returned indices.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

__all__ = ["knn", "knn_reference", "prepare_targets", "KnnTargets", "knn_kernel"]

# (B, chunk, T) distance elements per chunk of the plain version: small
# enough for a CPU core's cache, or 64 MB of float32 on a card
_REF_CHUNK_ELEMS = {"cpu": 1 << 18, "cuda": 1 << 24}


class KnnTargets(NamedTuple):
    """A target set prepared once for many :func:`knn` calls.

    Attributes:
        packed: (B, T, 4) float32 rows ``[x, y, z, w]`` (detached), with
            ``w = 0`` for a valid target and ``+inf`` for an invalid one.
        num_targets: T.
    """

    packed: torch.Tensor
    num_targets: int

    @property
    def tgt(self) -> torch.Tensor:
        return self.packed[..., 0:3]

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.packed[..., 3])


def prepare_targets(tgt: torch.Tensor, tgt_valid: Optional[torch.Tensor] = None) -> KnnTargets:
    """Packs targets and bakes validity into the fourth channel, once.

    The ICP solvers call :func:`knn` twice per iteration against the same
    targets, so this loop-invariant work is hoisted out of the solver loop.
    """
    if tgt.dim() != 3 or tgt.shape[-1] != 3:
        raise ValueError(f"tgt must be (B, T, 3), got {tuple(tgt.shape)}")
    tgt = tgt.detach()
    w = torch.zeros_like(tgt[..., :1])
    if tgt_valid is not None:
        w = w.masked_fill(~tgt_valid.bool()[..., None], torch.inf)
    return KnnTargets(torch.cat([tgt, w], dim=-1).contiguous(), tgt.shape[1])


def knn_reference(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_valid: Optional[torch.Tensor] = None,
):
    """Plain-PyTorch 1-NN: ``(sq_dists (B, S), idx (B, S) int32)``.

    Chunked over the sources so the (B, chunk, T) distance block stays
    within a fixed memory budget; each coordinate's term is rounded on its
    own, as in the kernel. ``torch.min`` over a row returns the index of
    the first minimum, as ``torch.argmin`` does, so ties go to the lowest
    index; it is a third faster on the CPU than argmin and a gather.
    Accepts float64.
    """
    B, S, _ = src.shape
    T = tgt.shape[1]
    if T == 0:
        return (
            torch.full((B, S), torch.inf, dtype=src.dtype, device=src.device),
            torch.zeros((B, S), dtype=torch.int32, device=src.device),
        )
    s = [c.contiguous() for c in src.detach().unbind(-1)]
    t = [c.contiguous()[:, None, :] for c in tgt.detach().unbind(-1)]
    invalid = None if tgt_valid is None else ~tgt_valid.bool()[:, None, :]
    chunk = max(1, _REF_CHUNK_ELEMS.get(src.device.type, 1 << 18) // (B * T))
    dists, idxs = [], []
    for s0 in range(0, S, chunk):
        rows = slice(s0, s0 + chunk)
        d = s[0][:, rows, None] - t[0]
        d.mul_(d)
        for c in (1, 2):
            e = s[c][:, rows, None] - t[c]
            d.add_(e.mul_(e))  # (dx*dx + dy*dy) + dz*dz
        if invalid is not None:
            d.masked_fill_(invalid, torch.inf)
        m, i = torch.min(d, dim=-1)
        dists.append(m)
        idxs.append(i.to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


class _KnnKernel:
    """The CUDA kernel's wrapper: builds ``csrc/knn.cu`` at first use,
    checks its inputs, launches it on the current stream and counts its
    launches in :attr:`launches`."""

    source = "knn.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        """Loads the kernel's library, building it first if needed."""
        if self._fn is None:
            from ..utils.cuda_build import build

            lib = ctypes.CDLL(str(build(self.source)))
            fn = lib.gst_knn
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, src: torch.Tensor, packed: torch.Tensor):
        """``src`` (B, S, 3) and ``packed`` (B, T, 4) float32 contiguous
        CUDA tensors on one device -> (dist (B, S) float32, idx (B, S) int32)."""
        if not (src.is_cuda and packed.is_cuda) or src.device != packed.device:
            raise ValueError("knn kernel: src and targets must be on one CUDA device")
        if src.dtype != torch.float32 or packed.dtype != torch.float32:
            raise TypeError(f"knn kernel takes float32, got {src.dtype} and {packed.dtype}")
        if src.dim() != 3 or src.shape[-1] != 3 or packed.dim() != 3 or packed.shape[-1] != 4:
            raise ValueError(
                f"knn kernel: src (B, S, 3) and targets (B, T, 4), got "
                f"{tuple(src.shape)} and {tuple(packed.shape)}"
            )
        B, S, _ = src.shape
        T = packed.shape[1]
        if packed.shape[0] != B:
            raise ValueError(f"knn kernel: batch {B} vs {packed.shape[0]}")
        if B > 65535 or (T + 511) // 512 > 65535 or B * S >= 2**31 or T >= 2**31:
            raise ValueError(f"knn kernel: sizes out of range (B={B}, S={S}, T={T})")
        if not (src.is_contiguous() and packed.is_contiguous()):
            raise ValueError("knn kernel: inputs must be contiguous")
        if packed.data_ptr() % 16:
            raise ValueError("knn kernel: targets must be 16-byte aligned")
        fn = self.load()
        dist = torch.empty((B, S), dtype=torch.float32, device=src.device)
        idx = torch.empty((B, S), dtype=torch.int32, device=src.device)
        scratch = torch.empty((B, S), dtype=torch.int64, device=src.device)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(
                src.data_ptr(), packed.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                scratch.data_ptr(), B, S, T, stream,
            )
        if err != 0:
            raise RuntimeError(f"knn kernel launch failed: cudaError {err}")
        self.launches += 1
        return dist, idx


knn_kernel = _KnnKernel()


def knn(
    src: torch.Tensor,
    tgt: Union[torch.Tensor, KnnTargets],
    tgt_valid: Optional[torch.Tensor] = None,
):
    """Batched exact 1-NN from ``src`` to ``tgt``.

    Args:
        src: (B, S, 3) query points.
        tgt: (B, T, 3) target points, or :class:`KnnTargets` from
            :func:`prepare_targets` (``tgt_valid`` is then ignored).
        tgt_valid: optional (B, T) bool; invalid targets never match.

    Returns:
        (sq_dists, idx): (B, S) squared distances and (B, S) int32 indices,
        both detached. A CUDA ``src`` runs the Hopper kernel (float32 only);
        a CPU ``src`` runs :func:`knn_reference`.
    """
    if src.dim() != 3 or src.shape[-1] != 3:
        raise ValueError(f"src must be (B, S, 3), got {tuple(src.shape)}")
    if src.is_cuda:
        packed = tgt.packed if isinstance(tgt, KnnTargets) else prepare_targets(tgt, tgt_valid).packed
        return knn_kernel(src.detach().contiguous(), packed)
    if isinstance(tgt, KnnTargets):
        return knn_reference(src, tgt.tgt, tgt.valid)
    return knn_reference(src, tgt, tgt_valid)
