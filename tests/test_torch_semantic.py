"""Semantic label fusion: the port against the JAX package, the five cases
of ``tests/slam/test_semantic.py`` and the aggregate and gated paths.

Each case runs ``slam_sequence`` with ``labels_seq`` in both packages from
the same numpy inputs (the msrd clip, 120x160). ``num_points`` and the label
channel are exactly equal; the label confidence, a sum of the same alphas,
agrees to rtol 2e-5 as the fused floats do (``test_torch_fusion.py``).
Labels enter no gate or winner key, so the port's channels 0-9 and poses
are bit-identical with and without them, and under one constant label the
confidence equals the ccount bit for bit.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch.slam import icpslam as TS

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160


def _golden(L):
    idx = [i % 3 for i in range(L)]
    return tuple(np.load(DATA / f"{n}.npy").astype(np.float32)[:, idx] if n != "intrinsics"
                 else np.load(DATA / f"{n}.npy").astype(np.float32)
                 for n in ("colors", "depths", "intrinsics", "poses"))


def _run(colors, depths, K, poses, labels, capacity, **kw):
    """(JAX map data and num_points, port MapState, port poses)."""
    mj, _ = JS.slam_sequence(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K),
                             None if poses is None else jnp.asarray(poses), JS.SLAMOptions(**kw), capacity,
                             labels_seq=None if labels is None else jnp.asarray(labels))
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
    mt, pt = TS.slam_sequence(t(colors), t(depths), t(K), t(poses), TS.SLAMOptions(**kw), capacity,
                              labels_seq=t(labels))
    return (np.asarray(mj.data), np.asarray(mj.num_points)), mt, pt


def _check_vs_jax(jax_map, mt):
    jd, jn = jax_map
    np.testing.assert_array_equal(mt.num_points.numpy(), jn)
    td = mt.data.numpy()
    np.testing.assert_array_equal(td[..., 10], jd[..., 10])
    np.testing.assert_allclose(td[..., 11], jd[..., 11], rtol=2e-5, atol=1e-6)


def _halves(B, L):
    lab = np.where(np.arange(W)[None, :] < W // 2, 1.0, 2.0)
    return np.broadcast_to(lab, (B, L, H, W)).astype(np.float32).copy()


def _live(mt, b=0):
    n = int(mt.num_points[b])
    return mt.labels[b, :n].numpy(), mt.label_conf[b, :n].numpy()


def test_labels_land_in_arena():
    colors, depths, K, poses = _golden(3)
    jm, mt, _ = _run(colors, depths, K, poses, _halves(2, 3), 3 * H * W, odom="gt", fusion=True)
    _check_vs_jax(jm, mt)
    labs, confs = _live(mt)
    assert set(np.unique(labs)) <= {1.0, 2.0}
    assert (confs > 0).all()
    assert 0.2 < (labs == 1.0).mean() < 0.8


def test_merges_grow_confidence():
    colors, depths, K, poses = _golden(1)
    rep = lambda x, n: np.concatenate([x] * n, axis=1)
    labels = np.full((2, 3, H, W), 5.0, np.float32)
    jm1, m1, _ = _run(colors, depths, K, poses, labels[:, :1], 3 * H * W, odom="gt", fusion=True)
    jm3, m3, _ = _run(rep(colors, 3), rep(depths, 3), K, rep(poses, 3), labels, 3 * H * W, odom="gt", fusion=True)
    _check_vs_jax(jm1, m1)
    _check_vs_jax(jm3, m3)
    n = int(m1.num_points[0])
    assert _live(m3)[1][:n].mean() > 1.5 * _live(m1)[1].mean()
    assert (m3.labels[0, :n].numpy() == 5.0).all()


def test_majority_flip():
    colors, depths, K, poses = _golden(1)
    rep = lambda x: np.concatenate([x] * 4, axis=1)
    labels = np.full((2, 4, H, W), 2.0, np.float32)
    labels[:, 0] = 1.0
    jm, mt, _ = _run(rep(colors), rep(depths), K, rep(poses), labels, 4 * H * W, odom="gt", fusion=True)
    _check_vs_jax(jm, mt)
    assert (_live(mt)[0] == 2.0).mean() > 0.9


@pytest.mark.parametrize("window_merge", ["dense", "rows"])
def test_labels_with_assoc_window(window_merge):
    """The capacity-windowed association gives the full-arena program's
    labels and counts, and JAX's windowed ones."""
    colors, depths, K, poses = _golden(3)
    labels = _halves(2, 3)
    jm, full, _ = _run(colors, depths, K, poses, labels, 3 * H * W, odom="gt", fusion=True)
    jw, win, _ = _run(colors, depths, K, poses, labels, 3 * H * W, odom="gt", fusion=True,
                      assoc_window=2 * H * W, window_merge=window_merge)
    _check_vs_jax(jm, full)
    _check_vs_jax(jw, win)
    np.testing.assert_array_equal(full.num_points.numpy(), win.num_points.numpy())
    np.testing.assert_array_equal(full.labels.numpy(), win.labels.numpy())
    np.testing.assert_allclose(full.label_conf.numpy(), win.label_conf.numpy(), rtol=1e-6, atol=1e-6)


def test_no_labels_unchanged():
    """Without labels the label channels stay zero; with one constant label
    channels 0-9 and the poses are bit-identical, every live label is that
    label and its confidence is the ccount."""
    colors, depths, K, _ = _golden(3)
    t = torch.from_numpy
    opts = TS.SLAMOptions(odom="gradicp", numiters=4, fusion=True)
    m0, p0 = TS.slam_sequence(t(colors), t(depths), t(K), None, opts, 3 * H * W)
    assert float(m0.data[..., 10:12].abs().max()) == 0.0
    labels = np.full((2, 3, H, W), 7.0, np.float32)
    jm, m1, p1 = _run(colors, depths, K, None, labels, 3 * H * W, odom="gradicp", numiters=4, fusion=True)
    _check_vs_jax(jm, m1)
    assert torch.equal(p0, p1)
    assert torch.equal(m0.data[..., :10], m1.data[..., :10])
    for b in range(2):
        labs, confs = _live(m1, b)
        assert (labs == 7.0).all()
        np.testing.assert_array_equal(confs, m1.ccounts[b, : len(confs), 0].numpy())


@pytest.mark.parametrize("path", ["ICPSLAM", "gated"])
def test_labels_on_other_mapping_paths(path):
    """Aggregate mapping (every pixel appended with its label at confidence
    alpha) and block-gated fusion carry labels as JAX does."""
    colors, depths, K, poses = _golden(3)
    kw = dict(fusion=False) if path == "ICPSLAM" else dict(fusion=True, block_size=1024)
    jm, mt, _ = _run(colors, depths, K, poses, _halves(2, 3), 3 * H * W, odom="gt", **kw)
    _check_vs_jax(jm, mt)
    labs, confs = _live(mt)
    assert set(np.unique(labs)) <= {1.0, 2.0} and (confs > 0).all()
