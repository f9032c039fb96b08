"""One gradLM point-to-plane ICP iteration in three passes (no TPU counterpart).

The steps of :func:`odometry.icputils.point_to_plane_gradICP` between its
two KNN calls, on fixed buffers that each pass fills in place:

- :func:`linearize`: the point-to-plane rows of every source against its
  nearest target and, for each block of :data:`SOURCES_PER_BLOCK` sources,
  the :data:`TERMS` sums of the weighted normal equations (the 21 upper
  entries of ``AᵀWA`` in row-major order, the 6 of ``AᵀWb``, ``Σ w b²``);
- :func:`lookahead`: the damped 6×6 solve over every block's sums, and the
  sources moved by its step (``xi`` and the error before it beside);
- :func:`update`: the lookahead's error, gradLM's gates, and the gated step
  applied to the sources, the pose and the damping.

On a CUDA tensor each launches its kernel in ``csrc/icp_system.cu``
(:data:`icp_system_kernel`); on a CPU tensor it runs its plain version
(``*_reference``), the op-by-op arithmetic of ``icputils``. There is no
fallback between the two: a CUDA input that the kernel does not take
raises. The kernels sum in another order than the plain versions, and
otherwise compute the same float32 numbers.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..geometry.geometryutils import transform_pointcloud
from ..geometry.projutils import matmul_small
from ..geometry.se3 import se3_exp
from ..utils.cuda_build import CudaLibrary, check_inputs

__all__ = [
    "SOURCES_PER_BLOCK",
    "TERMS",
    "Gates",
    "num_blocks",
    "linearize",
    "linearize_reference",
    "lookahead",
    "lookahead_reference",
    "update",
    "update_reference",
    "icp_system_kernel",
]

SOURCES_PER_BLOCK = 256  # csrc/icp_system.cu: 128 threads, 2 sources each
TERMS = 28  # 21 of AᵀWA, 6 of AᵀWb, Σ w b²
_UPPER = torch.triu_indices(6, 6)


class Gates(NamedTuple):
    """gradLM's gates as the update takes them: ``-B``, ``-B2``, ``1 / nu``,
    ``lambda_min = 1 / lambda_max`` and ``lambda_max - lambda_min``, each a
    Python float rounded to float32 where it meets a tensor."""

    neg_b: float
    neg_b2: float
    inv_nu: float
    lambda_min: float
    lambda_range: float

    @classmethod
    def of(cls, lambda_max: float, B: float, B2: float, nu: float) -> "Gates":
        lambda_min = 1.0 / lambda_max
        return cls(-B, -B2, 1.0 / nu, lambda_min, lambda_max - lambda_min)


def num_blocks(S: int) -> int:
    """Blocks of sources a batch element's sums come in (at least one)."""
    return max(1, -(-S // SOURCES_PER_BLOCK))


def linearize_reference(src, dist, idx, tgt_packed, src_w, dist_thresh, robust_delta, partials):
    """Plain-PyTorch :func:`linearize`: the rows and weights of
    ``icputils.gauss_newton_solve``, summed a block at a time."""
    from ..odometry.icputils import _point_to_plane_rows

    B, S, _ = src.shape
    w = torch.isfinite(dist).to(src.dtype)
    if dist_thresh is not None:
        w = w * (dist < dist_thresh)
    if src_w is not None:
        w = w * src_w
    rows = torch.gather(tgt_packed, 1, idx.long()[..., None].expand(-1, -1, 6))
    A, b, w = _point_to_plane_rows(src, rows[..., 0:3], rows[..., 3:6], w, robust_delta)
    Aw = A * w[..., None]
    terms = torch.cat([(Aw[..., :, None] * A[..., None, :])[..., _UPPER[0], _UPPER[1]], Aw * b,
                       w[..., None] * b**2], dim=-1)
    nblk = partials.shape[1]
    terms = torch.nn.functional.pad(terms, (0, 0, 0, nblk * SOURCES_PER_BLOCK - S))
    partials.copy_(terms.reshape(B, nblk, SOURCES_PER_BLOCK, TERMS).sum(2))


def lookahead_reference(src, partials, damp, xi, err, one_step):
    """Plain-PyTorch :func:`lookahead`."""
    sums = partials.sum(1)
    AtA = torch.zeros(sums.shape[:1] + (6, 6), dtype=sums.dtype, device=sums.device)
    AtA[:, _UPPER[0], _UPPER[1]] = sums[:, :21]
    AtA[:, _UPPER[1], _UPPER[0]] = sums[:, :21]
    AtA = AtA + torch.eye(6, dtype=sums.dtype, device=sums.device) * damp[:, None, None]
    x = torch.linalg.solve_ex(AtA, sums[:, 21:27, None], check_errors=False)[0][..., 0]
    xi.copy_(x)
    err.copy_(sums[:, TERMS - 1])
    one_step.copy_(transform_pointcloud(src, se3_exp(x)))


def update_reference(src, partials, xi, err, damp, transform, gates: Gates):
    """Plain-PyTorch :func:`update`."""
    new_err = partials[..., TERMS - 1].sum(1)
    errdiff = torch.clamp(new_err - err, -70.0, 70.0)
    sigmoid = 1.0 / (1.0 + torch.exp(gates.neg_b2 * errdiff)) ** gates.inv_nu
    rt = se3_exp(sigmoid[:, None] * xi)
    damp.copy_(damp * (gates.lambda_min + gates.lambda_range / (1.0 + torch.exp(gates.neg_b * errdiff))))
    src.copy_(transform_pointcloud(src, rt))
    transform.copy_(matmul_small(rt, transform))


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_F32 = torch.float32


class _IcpSystemKernel(CudaLibrary):
    """The CUDA kernels' wrapper: builds ``csrc/icp_system.cu`` at first use,
    checks its inputs, launches each pass on the current stream and counts
    the kernels launched in :attr:`launches` (one a pass). It allocates
    nothing: every output is a buffer its caller passes."""

    name = "icp_system"
    source = "icp_system.cu"
    entries = {
        "gs_icp_linearize_launch": [_P, _P, _P, _P, _LL, _P, _I, _I, _I, _F, _I, _F, _P, _P],
        "gs_icp_lookahead_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
        "gs_icp_update_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _P],
    }

    def linearize(self, src, dist, idx, tgt_packed, src_w, dist_thresh, robust_delta, partials):
        B, S = self._check(src, partials, dist=(dist, _F32, ("B", "S")), idx=(idx, torch.int32, ("B", "S")),
                           tgt_packed=(tgt_packed, _F32, ("B", "T", 6)), src_w=(src_w, _F32, ("B", "S")))
        self.invoke("gs_icp_linearize_launch", src.device, src.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                    tgt_packed.data_ptr(), tgt_packed.shape[1], None if src_w is None else src_w.data_ptr(), B, S,
                    dist_thresh is not None, 0.0 if dist_thresh is None else dist_thresh, robust_delta is not None,
                    0.0 if robust_delta is None else robust_delta, partials.data_ptr())

    def lookahead(self, src, partials, damp, xi, err, one_step):
        B, S = self._check(src, partials, damp=(damp, _F32, ("B",)), xi=(xi, _F32, ("B", 6)), err=(err, _F32, ("B",)),
                           one_step=(one_step, _F32, ("B", "S", 3)))
        self.invoke("gs_icp_lookahead_launch", src.device, src.data_ptr(), B, S, partials.data_ptr(),
                    damp.data_ptr(), xi.data_ptr(), err.data_ptr(), one_step.data_ptr())

    def update(self, src, partials, xi, err, damp, transform, gates: Gates):
        B, S = self._check(src, partials, xi=(xi, _F32, ("B", 6)), err=(err, _F32, ("B",)),
                           damp=(damp, _F32, ("B",)), transform=(transform, _F32, ("B", 4, 4)))
        self.invoke("gs_icp_update_launch", src.device, src.data_ptr(), B, S, partials.data_ptr(), xi.data_ptr(),
                    err.data_ptr(), damp.data_ptr(), transform.data_ptr(), *gates)

    @staticmethod
    def _check(src, partials, **inputs):
        """Checks the sources (B, S, 3), the block sums (B, num_blocks(S),
        TERMS) and ``inputs`` (:func:`check_inputs`' form) -> (B, S)."""
        S = src.shape[1] if src.dim() == 3 else 0
        check_inputs("icp system kernel", src=(src, _F32, ("B", "S", 3)),
                     partials=(partials, _F32, ("B", num_blocks(S), TERMS)), **inputs)
        B, S = src.shape[:2]
        if B > 65535 or B * S >= 2**31:
            raise ValueError(f"icp system kernel: sizes out of range (B={B}, S={S})")
        return B, S


icp_system_kernel = _IcpSystemKernel()


def _same_device(src, *tensors):
    for t in tensors:
        if t is not None and t.device != src.device:
            raise ValueError(f"icp system: an input is on {t.device}, the sources on {src.device}")


def linearize(src: torch.Tensor, dist: torch.Tensor, idx: torch.Tensor, tgt_packed: torch.Tensor,
              src_w: Optional[torch.Tensor], dist_thresh: Optional[float], robust_delta: Optional[float],
              partials: torch.Tensor) -> None:
    """Fills ``partials`` (B, :func:`num_blocks` (S), :data:`TERMS`) with each
    block's sums of the weighted point-to-plane normal equations.

    Args:
        src: (B, S, 3) sources; dist, idx: (B, S) their KNN output (float32,
            int32); tgt_packed: (B, T, 6) target rows ``[t, n]``;
        src_w: optional (B, S) source weights (validity);
        dist_thresh: optional squared-distance gate; robust_delta: optional
            Huber threshold on the residuals.
    """
    _same_device(src, dist, idx, tgt_packed, src_w, partials)
    if src.is_cuda:
        icp_system_kernel.linearize(src, dist, idx, tgt_packed, src_w, dist_thresh, robust_delta, partials)
    else:
        linearize_reference(src, dist, idx, tgt_packed, src_w, dist_thresh, robust_delta, partials)


def lookahead(src: torch.Tensor, partials: torch.Tensor, damp: torch.Tensor, xi: torch.Tensor, err: torch.Tensor,
              one_step: torch.Tensor) -> None:
    """Solves ``(AᵀWA + damp I) x = AᵀWb`` over every block's sums into ``xi``
    (B, 6), their ``Σ w b²`` into ``err`` (B,) and ``transform(src,
    se3_exp(x))`` into ``one_step`` (B, S, 3)."""
    _same_device(src, partials, damp, xi, err, one_step)
    if src.is_cuda:
        icp_system_kernel.lookahead(src, partials, damp, xi, err, one_step)
    else:
        lookahead_reference(src, partials, damp, xi, err, one_step)


def update(src: torch.Tensor, partials: torch.Tensor, xi: torch.Tensor, err: torch.Tensor, damp: torch.Tensor,
           transform: torch.Tensor, gates: Gates) -> None:
    """gradLM's gated step, in place: with ``new_err`` the sums' ``Σ w b²``
    and ``errdiff = clamp(new_err - err, -70, 70)``, ``rt = se3_exp(xi / (1 +
    exp(-B2 errdiff)) ** (1 / nu))`` moves ``src`` (B, S, 3) and multiplies
    ``transform`` (B, 4, 4) on the left, and ``damp`` (B,) takes gradLM's
    factor."""
    _same_device(src, partials, xi, err, damp, transform)
    if src.is_cuda:
        icp_system_kernel.update(src, partials, xi, err, damp, transform, gates)
    else:
        update_reference(src, partials, xi, err, damp, transform, gates)
