"""gradICP problems for the fused iteration's tests, shared by its CPU tests
(the plain versions against the op-by-op composition,
``test_torch_icputils.py``) and its card tests (the kernels against the
plain versions and the composition, ``test_torch_cuda.py``). Imports
neither JAX nor a card."""

import numpy as np
import torch

# the cases of the fused loop against the composition: point_to_plane_gradICP's
# keyword arguments, and the problem's changes ("no target": batch element 1
# has no valid target; "invalid sources": 30% of the sources invalid)
ICP_CASES = {
    "plain": (dict(), ()),
    "dist_thresh": (dict(dist_thresh=0.002), ()),
    "robust_delta": (dict(robust_delta=0.01), ()),
    "all gates": (dict(dist_thresh=0.002, robust_delta=0.01), ("invalid sources",)),
    "invalid sources": (dict(), ("invalid sources",)),
    "no target": (dict(dist_thresh=0.002), ("no target",)),
    "seeded, lm gates": (dict(lambda_max=4.0, B=2.0, B2=0.5, nu=100.0), ("seeded",)),
}


def icp_case(B, S, T, seed=0, n_valid=None, changes=()):
    """Sources near a smooth surface moved by a small pose, and the surface's
    targets with normals: dict of numpy float32 ``src`` (B, S, 3),
    ``tgt`` / ``tgt_n`` (B, T, 3), ``src_valid`` (B, S) and bool
    ``tgt_valid`` (B, T), the first ``n_valid`` targets valid (all by
    default)."""
    rng = np.random.default_rng(seed)
    n_valid = T if n_valid is None else n_valid
    xy = rng.uniform(-1, 1, (B, T, 2))
    x, y = xy[..., 0], xy[..., 1]
    z = 2 + 0.1 * np.sin(3 * x) * np.cos(2 * y)
    tgt = np.concatenate([xy, z[..., None]], -1)
    nrm = np.stack([-0.3 * np.cos(3 * x) * np.cos(2 * y), 0.2 * np.sin(3 * x) * np.sin(2 * y), np.ones_like(x)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pick = rng.integers(0, n_valid, (B, S))
    pts = np.take_along_axis(tgt, pick[..., None], 1)
    xi = rng.uniform(-1, 1, (B, 6)) * np.array([0.02, 0.02, 0.02, 0.015, 0.015, 0.015])
    T_ = _se3_exp64(xi)
    src = np.einsum("bij,bsj->bsi", T_[:, :3, :3], pts) + T_[:, None, :3, 3]
    src += rng.normal(0, 1e-3, src.shape)
    src_valid = np.ones((B, S))
    if "invalid sources" in changes:
        src_valid = (rng.random((B, S)) > 0.3).astype(np.float64)
    tgt_valid = np.arange(T)[None, :].repeat(B, 0) < n_valid
    if "no target" in changes:
        tgt_valid[1] = False
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    case = dict(src=f32(src), tgt=f32(tgt), tgt_n=f32(nrm), src_valid=f32(src_valid), tgt_valid=tgt_valid)
    if "seeded" in changes:  # an initial transform half way back
        case["initial_transform"] = f32(np.linalg.inv(_se3_exp64(xi / 2)))
    return case


def gradicp_kwargs(case, name):
    """``point_to_plane_gradICP``'s keyword arguments for a torch case and
    an ``ICP_CASES`` entry."""
    kw = dict(ICP_CASES[name][0], src_valid=case["src_valid"], tgt_valid=case["tgt_valid"])
    if "initial_transform" in case:
        kw["initial_transform"] = case["initial_transform"]
    return kw


def _se3_exp64(xi):
    """Rodrigues' SE(3) exponential in float64, (B, 6) -> (B, 4, 4)."""
    out = np.tile(np.eye(4), (xi.shape[0], 1, 1))
    for b, (v, w) in enumerate(zip(xi[:, :3], xi[:, 3:])):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        A, B_, C = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
        out[b, :3, :3] = np.eye(3) + A * K + B_ * K @ K
        out[b, :3, 3] = (np.eye(3) + B_ * K + C * K @ K) @ v
    return out


def torch_case(case, device):
    """``icp_case``'s arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in case.items()}


def sums_scale(sums):
    """(B, 28) sums of the normal equations -> the scale of each sum's
    rounding: a sum of products ``w u v`` is at most ``sqrt(Σ w u² · Σ w v²)``
    in absolute terms (Cauchy-Schwarz), with u, v the rows' six entries
    (``AᵀWA``'s diagonal) or the residual (``Σ w b²``)."""
    iu = torch.triu_indices(6, 6)
    diag = torch.cat([sums[:, :21][:, iu[0] == iu[1]], sums[:, 27:28]], 1).abs()  # (B, 7): the 6 a², then b²
    pairs = torch.cat([iu, torch.stack([torch.arange(6), torch.full((6,), 6)]), torch.tensor([[6], [6]])], 1)
    return torch.sqrt(diag[:, pairs[0]] * diag[:, pairs[1]])
