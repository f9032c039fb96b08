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

from ..utils.cuda_build import CudaLibrary, check_inputs

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
        limit: (B,) int32, one past the last valid target of each batch
            entry (0 when it has none). No target at or beyond it is valid,
            so the kernel reads none of them: on the main path the valid
            targets are a prefix and ``limit`` is their count.
    """

    packed: torch.Tensor
    num_targets: int
    limit: torch.Tensor

    @property
    def tgt(self) -> torch.Tensor:
        return self.packed[..., 0:3]

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.packed[..., 3])


def prepare_targets(tgt: torch.Tensor, tgt_valid: Optional[torch.Tensor] = None) -> KnnTargets:
    """Packs targets, bakes validity into the fourth channel and finds each
    batch entry's ``limit``, once, on the targets' device (no host sync).

    The ICP solvers call :func:`knn` twice per iteration against the same
    targets, so this loop-invariant work is hoisted out of the solver loop.
    """
    if tgt.dim() != 3 or tgt.shape[-1] != 3:
        raise ValueError(f"tgt must be (B, T, 3), got {tuple(tgt.shape)}")
    B, T, _ = tgt.shape
    tgt = tgt.detach()
    w = torch.zeros_like(tgt[..., :1])
    if tgt_valid is None or T == 0:
        limit = torch.full((B,), T, dtype=torch.int32, device=tgt.device)
    else:
        valid = tgt_valid.bool()
        w = w.masked_fill(~valid[..., None], torch.inf)
        pos = torch.arange(1, T + 1, dtype=torch.int32, device=tgt.device)
        limit = torch.where(valid, pos, 0).amax(dim=1).to(torch.int32)
    return KnnTargets(torch.cat([tgt, w], dim=-1).contiguous(), T, limit)


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


class _KnnKernel(CudaLibrary):
    """The CUDA kernel's wrapper: builds ``csrc/knn.cu`` at first use,
    checks its inputs, launches it on the current stream and counts its
    launches in :attr:`launches`."""

    name = "knn"
    source = "knn.cu"
    entries = {"gst_knn": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}

    @staticmethod
    def tiles(B: int, S: int, T: int):
        """(sources a lane, blocks a cluster) for a call's shapes, chosen on
        the card with ``tools/knn_tiles.py``: the targets split over up to 8
        blocks of 4 warps, one warp part per 64-target round of T; 4
        sources a lane where that still gives the 132 SMs 4 blocks each,
        else 2."""
        splits = max(1, min(8, -(-T // 256)))
        return (4 if B * -(-S // 128) * splits >= 4 * 132 else 2), splits

    def __call__(self, src: torch.Tensor, packed: torch.Tensor, limit: torch.Tensor):
        """``src`` (B, S, 3) and ``packed`` (B, T, 4) float32 contiguous
        CUDA tensors and ``limit`` (B,) int32 on one device -> (dist (B, S)
        float32, idx (B, S) int32)."""
        B, S = src.shape[:2]
        return self.launch(src, packed, limit, *self.tiles(B, S, packed.shape[1]))

    def launch(self, src, packed, limit, k: int, splits: int):
        """One launch with explicit tiles (:meth:`tiles` picks them)."""
        check_inputs("knn kernel", src=(src, torch.float32, ("B", "S", 3)),
                     targets=(packed, torch.float32, ("B", "T", 4)), limit=(limit, torch.int32, ("B",)))
        B, S, _ = src.shape
        T = packed.shape[1]
        if k not in (2, 4) or not 1 <= splits <= 8:
            raise ValueError(f"knn kernel: no tiles k={k}, splits={splits}")
        if B > 65535 or B * S >= 2**31 or B * T >= 2**31:
            raise ValueError(f"knn kernel: sizes out of range (B={B}, S={S}, T={T})")
        if packed.data_ptr() % 16:
            raise ValueError("knn kernel: targets must be 16-byte aligned")
        dist = torch.empty((B, S), dtype=torch.float32, device=src.device)
        idx = torch.empty((B, S), dtype=torch.int32, device=src.device)
        if B * S:
            self.invoke("gst_knn", src.device, src.data_ptr(), packed.data_ptr(), limit.data_ptr(), dist.data_ptr(),
                        idx.data_ptr(), B, S, T, k, splits)
        return dist, idx


knn_kernel = _KnnKernel()


def knn(
    src: torch.Tensor,
    tgt: Union[torch.Tensor, KnnTargets],
    tgt_valid: Optional[torch.Tensor] = None,
    *,
    use_pallas: Optional[bool] = None,
):
    """Batched exact 1-NN from ``src`` to ``tgt``.

    Args:
        src: (B, S, 3) query points.
        tgt: (B, T, 3) target points, or :class:`KnnTargets` from
            :func:`prepare_targets` (``tgt_valid`` is then ignored).
        tgt_valid: optional (B, T) bool; invalid targets never match.
        use_pallas: accepted for the JAX package's signature only: the
            device of ``src`` picks the route. None: the Hopper kernel on a
            CUDA ``src``, :func:`knn_reference` on a CPU one. True asks for
            the kernel and raises on a CPU ``src``; False asks for the plain
            version and raises on a CUDA one.

    Returns:
        (sq_dists, idx): (B, S) squared distances and (B, S) int32 indices,
        both detached. The kernel takes float32 only.
    """
    if src.dim() != 3 or src.shape[-1] != 3:
        raise ValueError(f"src must be (B, S, 3), got {tuple(src.shape)}")
    if use_pallas is not None and bool(use_pallas) != src.is_cuda:
        raise ValueError(f"use_pallas={use_pallas} does not fit src on {src.device}: the kernel runs on a CUDA "
                         "tensor and the plain version on a CPU one")
    if src.is_cuda:
        prep = tgt if isinstance(tgt, KnnTargets) else prepare_targets(tgt, tgt_valid)
        return knn_kernel(src.detach().contiguous(), prep.packed, prep.limit)
    if isinstance(tgt, KnnTargets):
        return knn_reference(src, tgt.tgt, tgt.valid)
    return knn_reference(src, tgt, tgt_valid)
