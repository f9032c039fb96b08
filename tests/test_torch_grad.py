"""Backward through the whole SLAM sequence: the port's gradient against the
JAX package's, and against central differences in float64.

The pose loss ``sum(poses[:, 1:, :3, 3] ** 2)`` of ``slam_sequence`` (the
msrd clip at 30x40, B=2, L=3, gradicp with 3 iterations, dsratio 2) is
differentiated with respect to the depth maps in both packages from the
same numpy inputs, for every mapping path: exact fusion (``PointFusion()``),
projective association with a 2*H*W window, the windowed 'dense' and
'rows' merges, aggregate mapping (``ICPSLAM``), block-gated fusion and
exact fusion with semantic labels. Tolerance: 1e-3 of the largest |JAX
gradient|; the measured gap is at most 2.6e-5 of it. The gated path's
gradient is the ungated one's to 1e-6 of its largest value: the visible
sub-arena only selects which rows are associated. Every
path appends through ``maparena.scatter_rows``, whose gradient gave each
kept row its slot's gradient once per dropped row as well (up to 4,500x
the JAX gradient here) until its fallback writers were detached.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.structures.maparena import scatter_rows

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"


def _clip(stride, dtype=np.float32, B=2):
    """The msrd clip at every ``stride``-th pixel, intrinsics scaled with it."""
    colors = np.load(DATA / "colors.npy")[:B, :, ::stride, ::stride].astype(dtype)
    depths = np.load(DATA / "depths.npy")[:B, :, ::stride, ::stride].astype(dtype)
    K = np.load(DATA / "intrinsics.npy")[:B].astype(dtype).copy()
    K[:, :, :2] /= stride
    return colors, depths, K


H, W = 30, 40
PATHS = {
    "PointFusion": dict(fusion=True),
    "projective window": dict(fusion=True, assoc="projective", assoc_window=2 * H * W),
    "dense window": dict(fusion=True, assoc_window=2 * H * W),
    "rows window": dict(fusion=True, assoc_window=2 * H * W, window_merge="rows"),
    "ICPSLAM": dict(fusion=False),
    "gated": dict(fusion=True, block_size=256),
    "PointFusion + labels": dict(fusion=True, labels=True),
}


def _labels(B, L):
    """Two classes, the left and right halves of every frame."""
    lab = np.where(np.arange(W)[None, :] < W // 2, 1.0, 2.0)
    return np.broadcast_to(lab, (B, L, H, W)).astype(np.float32).copy()


def _pose_loss(poses):
    return (poses[:, 1:, :3, 3] ** 2).sum()


@pytest.mark.parametrize("path", list(PATHS))
def test_depth_gradient_matches_jax(path):
    colors, depths, K = _clip(4)
    assert colors.shape[2:4] == (H, W)
    cap = colors.shape[1] * H * W
    kw = dict(odom="gradicp", numiters=3, dsratio=2, **PATHS[path])
    labels = _labels(*colors.shape[:2]) if kw.pop("labels", False) else None

    def jax_loss(d):
        _, poses = JS.slam_sequence(jnp.asarray(colors), d, jnp.asarray(K), None, JS.SLAMOptions(**kw), cap,
                                    labels_seq=None if labels is None else jnp.asarray(labels))
        return _pose_loss(poses)

    gj = np.asarray(jax.grad(jax_loss)(jnp.asarray(depths)))
    d = torch.from_numpy(depths).requires_grad_(True)
    _, poses = TS.slam_sequence(torch.from_numpy(colors), d, torch.from_numpy(K), None, TS.SLAMOptions(**kw), cap,
                                labels_seq=None if labels is None else torch.from_numpy(labels))
    _pose_loss(poses).backward()
    scale = np.abs(gj).max()
    assert scale > 0 and np.isfinite(gj).all()
    err = np.abs(d.grad.numpy() - gj).max()
    assert err <= 1e-3 * scale, (path, err / scale)


def test_gated_gradient_equals_ungated():
    colors, depths, K = _clip(4)
    cap = colors.shape[1] * H * W
    grads = []
    for gate in ({}, dict(block_size=256)):
        d = torch.from_numpy(depths).requires_grad_(True)
        opts = TS.SLAMOptions(odom="gradicp", numiters=3, dsratio=2, fusion=True, **gate)
        _, poses = TS.slam_sequence(torch.from_numpy(colors), d, torch.from_numpy(K), None, opts, cap)
        _pose_loss(poses).backward()
        grads.append(d.grad)
    scale = float(grads[0].abs().max())
    assert scale > 0
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("kept", ["some kept", "none kept"])
def test_scatter_rows_gradient(kept):
    """Kept rows get their slot's output gradient once, dropped rows none,
    and ``data`` the gradient of every slot no kept row writes, in a batch
    entry with kept rows and in one with none. The forward writes the kept
    rows and leaves every other slot as it was."""
    gen = torch.Generator().manual_seed(0)
    B, CAP, M, C = 2, 9, 6, 4
    data = torch.randn(B, CAP, C, generator=gen, dtype=torch.float64, requires_grad=True)
    rows = torch.randn(B, M, C, generator=gen, dtype=torch.float64, requires_grad=True)
    slots = torch.tensor([[4, 1, 7, 12, 2, 5], [3, 0, 6, 8, 11, 2]])
    keep = torch.tensor([[False, True, True, False, True, False], [True, False, True, False, False, True]])
    if kept == "none kept":
        keep[1] = False
    slots = torch.where(keep, slots, torch.tensor(CAP + 7))  # dropped slots out of range
    out = scatter_rows(data, slots, rows, keep)
    grad_out = torch.randn(B, CAP, C, generator=gen, dtype=torch.float64)
    out.backward(grad_out)

    written = torch.zeros(B, CAP, dtype=torch.bool)
    want_out, want_rows = data.detach().clone(), torch.zeros_like(rows)
    for b in range(B):
        for m in range(M):
            if keep[b, m]:
                s = int(slots[b, m])
                written[b, s] = True
                want_out[b, s] = rows[b, m].detach()
                want_rows[b, m] = grad_out[b, s]
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(rows.grad, want_rows, rtol=0, atol=0)
    torch.testing.assert_close(data.grad, torch.where(written[..., None], 0.0, grad_out), rtol=0, atol=0)


def test_sequence_gradient_float64_central_differences():
    """The port's autograd gradient of the pose loss with respect to depth
    pixels of each frame against float64 central differences (eps 1e-6),
    on the KNN path with exact fusion (20x27, L=3): relative error within
    1e-5 (measured up to 9e-9)."""
    colors, depths, K = (torch.from_numpy(x) for x in _clip(6, np.float64, B=1))
    L, h, w = colors.shape[1:4]
    opts = TS.SLAMOptions(odom="gradicp", fusion=True, numiters=3, dsratio=2)

    def loss(d):
        _, poses = TS.slam_sequence(colors, d, K, None, opts, L * h * w)
        return _pose_loss(poses)

    d = depths.clone().requires_grad_(True)
    loss(d).backward()
    grad = d.grad.reshape(L, -1)
    eps = 1e-6
    for t in range(L):
        for i in torch.topk(grad[t].abs(), 2).indices.tolist():
            step = torch.zeros_like(depths).reshape(L, -1)
            step[t, i] = eps
            step = step.reshape(depths.shape)
            with torch.no_grad():
                fd = float(loss(depths + step) - loss(depths - step)) / (2 * eps)
            assert abs(fd) > 0
            assert abs(float(grad[t, i]) - fd) <= 1e-5 * abs(fd), (t, i, float(grad[t, i]), fd)
