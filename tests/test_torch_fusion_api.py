"""The dense association helpers and the reference's table-based fusion API:
the port against the JAX package, mirroring ``TestReprojectionInvariant``
and ``TestMapUpdates`` of ``tests/slam/test_fusionutils.py``.

Inputs are the msrd golden clip's frames 0 and 1 (B=2, 120x160). Every
integer output is exactly equal to JAX's: the ``[b, n, h, w]`` tables and
the similarity mask, the dense winners and ``pix_corr``, the counts. Fused
floats agree to rtol 2e-5 (``test_torch_fusion.py``). The best-unique
selection, which the port makes with the winner kernel's plain version
instead of JAX's host lexsort, is also held against it on crafted ties.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.slam as JSL
import gradslam_tpu.slam.fusionutils as JF
from gradslam_tpu.structures import Pointclouds as JPointclouds, RGBDImages as JRGBDImages
from gradslam_tpu.structures.utils import pointclouds_from_rgbdimages as j_from_rgbd
import gradslam_tpu_torch.slam as TSL
import gradslam_tpu_torch.slam.fusionutils as TF
from gradslam_tpu_torch.structures import Pointclouds, RGBDImages, pointclouds_from_rgbdimages

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
DOT_TH = float(np.cos(np.radians(20.0)))


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics", "poses")}


def _frame(clip, s, pkg="torch"):
    args = [clip["colors"][:, s : s + 1], clip["depths"][:, s : s + 1], clip["intrinsics"], clip["poses"][:, s : s + 1]]
    return RGBDImages(*args, device="cpu") if pkg == "torch" else JRGBDImages(*args)


def _with_ccounts(pc, ones):
    """The clouds of ``pointclouds_from_rgbdimages`` with ccount 1 on every
    live point, as the association's unique stage needs."""
    pc.features_padded = ones(pc)
    return pc


def _clouds(clip, s=0):
    t = _with_ccounts(pointclouds_from_rgbdimages(_frame(clip, s)),
                      lambda pc: pc.nonpad_mask[..., None].float())
    j = _with_ccounts(j_from_rgbd(_frame(clip, s, "jax")),
                      lambda pc: jnp.ones(pc.points_padded.shape[:2] + (1,)) * pc.nonpad_mask[..., None])
    return t, j


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- TestReprojectionInvariant ------------------------------------------------


def test_active_map_points_hit_valid_pixels(clip):
    t, j = _clouds(clip)
    table = TSL.find_active_map_points(t, _frame(clip, 0))
    _eq(table, JSL.find_active_map_points(j, _frame(clip, 0, "jax")))
    assert table.dtype == torch.int64
    valid = clip["depths"][:, 0, ..., 0] > 0
    tab = table.numpy()
    assert tab.shape[0] == valid.sum()
    assert valid[tab[:, 0], tab[:, 2], tab[:, 3]].all()


def test_correspondences_reproduce_colors(clip):
    t, j = _clouds(clip)
    table = TSL.find_correspondences(t, _frame(clip, 0), dist_th=0.05, dot_th=DOT_TH)
    _eq(table, JSL.find_correspondences(j, _frame(clip, 0, "jax"), dist_th=0.05, dot_th=DOT_TH))
    tab = table.numpy()
    got = t.colors_padded.numpy()[tab[:, 0], tab[:, 1]]
    np.testing.assert_allclose(got, clip["colors"][:, 0][tab[:, 0], tab[:, 2], tab[:, 3]], atol=1e-4)


def test_dense_matches_table_winner_count(clip):
    t, j = _clouds(clip)
    table = TSL.find_correspondences(t, _frame(clip, 0), dist_th=0.05, dot_th=DOT_TH).numpy()
    rgbd = _frame(clip, 0)
    corr = TSL.find_correspondences_dense(
        TF._pointclouds_to_mapstate(t), rgbd.global_vertex_map[:, 0], rgbd.global_normal_map[:, 0],
        rgbd.poses[:, 0], rgbd.intrinsics, 0.05, DOT_TH,
    )
    assert int(corr.winner.sum()) == table.shape[0]
    wb, wn = np.nonzero(corr.winner.numpy())
    assert set(zip(wb.tolist(), wn.tolist())) == set(zip(table[:, 0].tolist(), table[:, 1].tolist()))


# -- the dense helpers against JAX on a fused map --------------------------


def test_dense_association_and_fusion_match_jax(clip):
    """Frame 1 against the map of frames 0 and 1 (``update_map_fusion``):
    winners, projections and ``pix_corr`` exactly JAX's, and the fused map."""
    tm = TSL.update_map_fusion(TSL.update_map_fusion(Pointclouds(), _frame(clip, 0), 0.05, DOT_TH, 0.6),
                               _frame(clip, 1), 0.05, DOT_TH, 0.6)
    jm = JSL.update_map_fusion(JSL.update_map_fusion(JPointclouds(), _frame(clip, 0, "jax"), 0.05, DOT_TH, 0.6),
                               _frame(clip, 1, "jax"), 0.05, DOT_TH, 0.6)
    _eq(tm.num_points_per_pointcloud, jm.num_points_per_pointcloud)
    ts, js = TF._pointclouds_to_mapstate(tm), JF._pointclouds_to_mapstate(jm)
    np.testing.assert_allclose(ts.data.numpy(), np.asarray(js.data), rtol=2e-5, atol=1e-6)
    r, rj = _frame(clip, 1).to_channels_last(), _frame(clip, 1, "jax").to_channels_last()
    args = lambda r: (r.global_vertex_map[:, 0], r.global_normal_map[:, 0], r.poses[:, 0], r.intrinsics)
    # the JAX map's own rows, so the association sees identical inputs
    ts = TF.MapState(torch.from_numpy(np.array(js.data)), torch.from_numpy(np.array(js.num_points)))
    tc = TSL.find_correspondences_dense(ts, *args(r), 0.05, DOT_TH)
    jc = JSL.find_correspondences_dense(js, *args(rj), 0.05, DOT_TH)
    for name in ("winner", "h", "w", "active", "pix_corr"):
        _eq(getattr(tc, name), getattr(jc, name))
    assert int(tc.winner.sum()) > 10000
    maps = lambda r: (r.global_vertex_map[:, 0], r.global_normal_map[:, 0], r.vertex_map[:, 0],
                      r.rgb_image[:, 0], r.valid_depth_mask[:, 0, ..., 0])
    to = TSL.fuse_map_dense(ts, tc, *maps(r), 0.6)
    jo = JSL.fuse_map_dense(js, jc, *maps(rj), 0.6)
    _eq(to.num_points, jo.num_points)
    np.testing.assert_allclose(to.data.numpy(), np.asarray(jo.data), rtol=2e-5, atol=1e-6)


def test_similar_and_best_unique_tables_match_jax(clip):
    """The stages one by one on frame 1 against frame 0's map, whose points
    reach a pixel two or more at a time."""
    t, j = _clouds(clip)
    active = TSL.find_active_map_points(t, _frame(clip, 1))
    ja = JSL.find_active_map_points(j, _frame(clip, 1, "jax"))
    _eq(active, ja)
    sim, keep = TSL.find_similar_map_points(t, _frame(clip, 1), active, 0.05, DOT_TH)
    jsim, jkeep = JSL.find_similar_map_points(j, _frame(clip, 1, "jax"), ja, 0.05, DOT_TH)
    _eq(sim, jsim)
    _eq(keep, jkeep)
    pix = sim.numpy()[:, [0, 2, 3]]
    assert len(np.unique(pix, axis=0)) < len(pix)  # pixels with several candidates
    best = TSL.find_best_unique_correspondences(t, _frame(clip, 1), sim)
    _eq(best, JSL.find_best_unique_correspondences(j, _frame(clip, 1, "jax"), jsim))


def test_best_unique_ties_match_jax_lexsort(clip):
    """Crafted ties: rows share pixels, ccounts repeat, ray distances repeat
    (points on one ray at the same depth): the point index settles them as
    JAX's lexsort does."""
    rng = np.random.default_rng(0)
    B, N, H, W = 2, 300, 120, 160
    pts = rng.choice(np.array([0.5, 1.0], np.float32), (B, N, 3))
    cc = rng.choice(np.array([1.0, 2.0, 3.0], np.float32), (B, N, 1))
    rows = [np.stack([np.full(N, b), np.arange(N), rng.integers(0, 4, N), rng.integers(0, 3, N)], -1)
            for b in range(B)]
    table = np.concatenate(rows)[rng.permutation(B * N)].astype(np.int64)
    t = Pointclouds(torch.from_numpy(pts), features=torch.from_numpy(cc))
    j = JPointclouds(jnp.asarray(pts), features=jnp.asarray(cc))
    got = TSL.find_best_unique_correspondences(t, _frame(clip, 0), torch.from_numpy(table))
    _eq(got, JSL.find_best_unique_correspondences(j, _frame(clip, 0, "jax"), jnp.asarray(table)))
    assert got.shape[0] == B * 12  # one winner at each of the 4x3 pixels


def test_empty_tables_and_refusals(clip):
    t, _ = _clouds(clip)
    empty = torch.zeros((0, 4), dtype=torch.int64)
    assert TSL.find_active_map_points(Pointclouds(), _frame(clip, 0)).shape == (0, 4)
    assert TSL.find_best_unique_correspondences(t, _frame(clip, 0), empty).shape == (0, 4)
    sim, keep = TSL.find_similar_map_points(t, _frame(clip, 0), empty, 0.05, DOT_TH)
    assert sim.shape == (0, 4) and keep.shape == (0,)
    two = RGBDImages(clip["colors"][:, :2], clip["depths"][:, :2], clip["intrinsics"], clip["poses"][:, :2],
                     device="cpu")
    with pytest.raises(ValueError):
        TSL.find_active_map_points(t, two)
    with pytest.raises(ValueError):
        TSL.find_best_unique_correspondences(Pointclouds(t.points_padded), _frame(clip, 0),
                                             torch.zeros((1, 4), dtype=torch.int64))
    far = t + 100.0  # nothing projects into the frame
    with pytest.warns(UserWarning, match="No active map points"):
        assert TSL.find_active_map_points(far, _frame(clip, 0)).shape == (0, 4)


# -- TestMapUpdates -----------------------------------------------------------


def test_aggregate_counts(clip):
    pc = TSL.update_map_aggregate(Pointclouds(), _frame(clip, 0))
    v0 = (clip["depths"][:, 0, ..., 0] > 0).sum((1, 2))
    np.testing.assert_array_equal(pc.num_points_per_pointcloud.numpy(), v0)
    pc = TSL.update_map_aggregate(pc, _frame(clip, 1))
    v1 = (clip["depths"][:, 1, ..., 0] > 0).sum((1, 2))
    np.testing.assert_array_equal(pc.num_points_per_pointcloud.numpy(), v0 + v1)
    jpc = JSL.update_map_aggregate(JSL.update_map_aggregate(JPointclouds(), _frame(clip, 0, "jax")),
                                   _frame(clip, 1, "jax"))
    np.testing.assert_allclose(pc.points_padded.numpy(), np.asarray(jpc.points_padded), rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def refused(clip):
    """Frame 0 fused into an empty map, then fused again, in both packages."""
    once = TSL.update_map_fusion(Pointclouds(), _frame(clip, 0), 0.05, DOT_TH, 0.6)
    twice = TSL.update_map_fusion(once, _frame(clip, 0), 0.05, DOT_TH, 0.6)
    jonce = JSL.update_map_fusion(JPointclouds(), _frame(clip, 0, "jax"), 0.05, DOT_TH, 0.6)
    jtwice = JSL.update_map_fusion(jonce, _frame(clip, 0, "jax"), 0.05, DOT_TH, 0.6)
    for a, b in ((once, jonce), (twice, jtwice)):
        _eq(a.num_points_per_pointcloud, b.num_points_per_pointcloud)
        np.testing.assert_allclose(a.features_padded.numpy(), np.asarray(b.features_padded), rtol=2e-5)
    return once, twice


def test_fusion_no_growth_on_refusing_same_frame(refused):
    once, twice = refused
    n1, n2 = once.num_points_per_pointcloud.numpy(), twice.num_points_per_pointcloud.numpy()
    assert ((n2 - n1) / n1).max() < 0.05


def test_fusion_merge_preserves_positions_same_frame(refused):
    once, twice = refused
    n = int(once.num_points_per_pointcloud[0])
    np.testing.assert_allclose(once.points_padded[0, :n].numpy(), twice.points_padded[0, :n].numpy(), atol=1e-5)


def test_fusion_ccounts_increase(refused):
    once, twice = refused
    n = int(once.num_points_per_pointcloud[0])
    c1, c2 = once.features_padded[0, :n, 0].numpy(), twice.features_padded[0, :n, 0].numpy()
    assert (c2 >= c1 - 1e-6).all() and c2.mean() > c1.mean() * 1.5


def test_fuse_with_map_matches_jax(clip):
    """The table-based merge and append of frame 1 into frame 0's map."""
    t, j = _clouds(clip)
    table = TSL.find_correspondences(t, _frame(clip, 1), 0.05, DOT_TH)
    jtable = JSL.find_correspondences(j, _frame(clip, 1, "jax"), 0.05, DOT_TH)
    _eq(table, jtable)
    out = TSL.fuse_with_map(t, _frame(clip, 1), table, 0.6)
    jout = JSL.fuse_with_map(j, _frame(clip, 1, "jax"), jtable, 0.6)
    _eq(out.num_points_per_pointcloud, jout.num_points_per_pointcloud)
    for name in ("points_padded", "normals_padded", "colors_padded", "features_padded"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), rtol=2e-5, atol=1e-5)
    assert torch.equal(t.features_padded, _clouds(clip)[0].features_padded)  # the input is left as it was
