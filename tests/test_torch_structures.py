"""gradslam_tpu_torch.structures against the JAX package and the golden maps.

Inputs are the msrd golden clip and numpy batches from a fixed seed.
Vertex maps are exact (one product per term); normal and global maps are
compared at rtol/atol 1e-5 with the goldens (cross products and 3-term
rotations round differently from the reference's torch build) and at 2e-6
with JAX. Integer outputs and arena layouts are exact.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.structures.maparena as JM
import gradslam_tpu.structures.rgbdimages as JR
from gradslam_tpu.structures import Pointclouds as JPointclouds
import gradslam_tpu_torch.structures.maparena as TM
import gradslam_tpu_torch.structures.rgbdimages as TR
from gradslam_tpu_torch.structures import Pointclouds, RGBDImages

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32) for n in (
        "colors", "depths", "intrinsics", "poses", "vertex_map", "normal_map",
        "global_vertex_map", "global_normal_map")}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_maps_against_goldens_and_jax(clip):
    rgbd = RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], clip["poses"], device="cpu")
    np.testing.assert_array_equal(rgbd.vertex_map.numpy(), clip["vertex_map"])
    for name in ("normal_map", "global_vertex_map", "global_normal_map"):
        np.testing.assert_allclose(getattr(rgbd, name).numpy(), clip[name], rtol=1e-5, atol=1e-5)
    jr = JR.RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], clip["poses"])
    for name in ("vertex_map", "normal_map", "global_vertex_map", "global_normal_map"):
        np.testing.assert_allclose(
            getattr(rgbd, name).numpy(), np.asarray(getattr(jr, name)), rtol=2e-6, atol=2e-6
        )
    np.testing.assert_array_equal(rgbd.valid_depth_mask.numpy(), np.asarray(jr.valid_depth_mask))


def test_degenerate_normals_are_exact_zero(clip):
    """Pixels whose right and down neighbours are invalid have dh == dv: the
    normal is the exact zero (relative parallelism test), as in JAX."""
    vm = _t(clip["vertex_map"])
    valid = _t(clip["depths"] > 0)
    nt = TR.compute_normal_map(vm, valid).numpy()
    nj = np.asarray(JR.compute_normal_map(jnp.asarray(clip["vertex_map"]), jnp.asarray(clip["depths"] > 0)))
    zt, zj = np.all(nt == 0, -1), np.all(nj == 0, -1)
    np.testing.assert_array_equal(zt, zj)
    # a flat patch with parallel differences: dh x dv is rounding noise only
    flat = np.zeros((1, 1, 4, 4, 3), np.float32)
    flat[..., 0] = np.arange(4, dtype=np.float32) * 0.1
    flat[..., 1] = np.arange(4, dtype=np.float32) * 0.3
    flat[..., 2] = 1.0 + np.arange(4, dtype=np.float32)[:, None] * 0.0
    out = TR.compute_normal_map(_t(flat)).numpy()
    assert np.all(out == 0.0)
    # and at degenerate pixels of the clip the zero survives the validity mask
    assert zt.sum() > 0


def test_rgbdimages_api(clip):
    rgbd = RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], clip["poses"], device="cpu")
    assert rgbd.shape == (2, 3, 120, 160) and rgbd.device.type == "cpu"
    sub = rgbd[1, 2]
    assert sub.shape == (1, 1, 120, 160)
    np.testing.assert_array_equal(sub.vertex_map.numpy(), clip["vertex_map"][1:2, 2:3])
    cf = rgbd.to_channels_first()
    assert tuple(cf.vertex_map.shape) == (2, 3, 3, 120, 160)
    rgbd.poses = None
    assert torch.equal(rgbd.global_vertex_map, rgbd.vertex_map)
    with pytest.raises(ValueError):
        RGBDImages(clip["colors"][..., :2], clip["depths"], clip["intrinsics"], device="cpu")


def test_pixel_rays_match_jax():
    np.testing.assert_array_equal(TR.pixel_rays(5, 7).numpy(), np.asarray(JR.pixel_rays(5, 7)))


def _rows(rng, B, M):
    return rng.standard_normal((B, M, 12)).astype(np.float32)


@pytest.mark.parametrize("cap,M,start", [(50, 16, (0, 7)), (10, 16, (0, 3)), (40, 16, (30, 38))])
def test_append_rows_to_map(cap, M, start):
    """cap >= M (JAX window path), cap < M (JAX scatter path), and an append
    that overflows: rows past capacity are dropped, num_points clamps."""
    rng = np.random.default_rng(cap)
    data = _rows(rng, 2, cap)
    npts = np.asarray(start, np.int32)
    data[np.arange(cap)[None, :] >= npts[:, None]] = 0.0
    new = _rows(rng, 2, M)
    mask = rng.random((2, M)) > 0.4
    j = JM.append_rows_to_map(JM.MapState(jnp.asarray(data), jnp.asarray(npts)), jnp.asarray(new), jnp.asarray(mask))
    t = TM.append_rows_to_map(TM.map_state_from_numpy(data, npts, "cpu"), _t(new), _t(mask))
    np.testing.assert_array_equal(t.num_points.numpy(), np.asarray(j.num_points))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert (t.num_points.numpy() <= cap).all()


def test_append_to_map_and_overflow():
    m = TM.init_map(1, 4, device="cpu")
    pts = torch.ones((1, 6, 3))
    m2 = TM.append_to_map(m, pts, pts, pts, torch.ones((1, 6, 1)), torch.ones((1, 6), dtype=torch.bool))
    assert m2.num_points.tolist() == [4]
    assert m.num_points.tolist() == [0]  # the input arena is left as it was


def test_compact_map_matches_jax():
    rng = np.random.default_rng(3)
    data = _rows(rng, 2, 64)
    data[..., 9] = rng.uniform(0, 2, (2, 64))
    npts = np.array([50, 64], np.int32)
    j = JM.compact_map(JM.MapState(jnp.asarray(data), jnp.asarray(npts)), 1.0, keep_recent=5)
    t = TM.compact_map(TM.map_state_from_numpy(data, npts, "cpu"), 1.0, keep_recent=5)
    np.testing.assert_array_equal(t.num_points.numpy(), np.asarray(j.num_points))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_map_state_numpy_round_trip():
    rng = np.random.default_rng(4)
    data, npts = _rows(rng, 2, 20), np.array([3, 17], np.int32)
    m = TM.map_state_from_numpy(data, npts, device="cpu")
    d2, n2 = TM.map_state_to_numpy(m)
    np.testing.assert_array_equal(d2, data)
    np.testing.assert_array_equal(n2, npts)
    assert m.num_points.dtype == torch.int32 and m.capacity == 20
    np.testing.assert_array_equal(TM.map_mask(m).numpy(), np.asarray(JM.map_mask(JM.MapState(jnp.asarray(data), jnp.asarray(npts)))))
    np.testing.assert_array_equal(m.ccounts.numpy(), data[..., 9:10])


def test_pack_rows_and_pointclouds_from_map():
    rng = np.random.default_rng(5)
    p, n, c = (rng.standard_normal((2, 6, 3)).astype(np.float32) for _ in range(3))
    cc = rng.random((2, 6, 1)).astype(np.float32)
    np.testing.assert_array_equal(TM.pack_rows(_t(p), _t(n), _t(c), _t(cc)).numpy(),
                                  np.asarray(JM.pack_rows(p, n, c, cc)))
    m = TM.append_to_map(TM.init_map(2, 10, device="cpu"), _t(p), _t(n), _t(c), _t(cc),
                         _t(rng.random((2, 6)) > 0.5))
    pc = TM.map_to_pointclouds(m)
    assert torch.equal(pc.num_points_per_pointcloud, m.num_points)
    for b, pts in enumerate(pc.points_list):
        np.testing.assert_array_equal(pts.numpy(), m.points[b, : int(m.num_points[b])].numpy())


def test_pointclouds_accessors():
    rng = np.random.default_rng(6)
    pts = [rng.standard_normal((n, 3)).astype(np.float32) for n in (4, 7)]
    nrm = [rng.standard_normal((n, 3)).astype(np.float32) for n in (4, 7)]
    t = Pointclouds([_t(p) for p in pts], normals=[_t(x) for x in nrm])
    j = JPointclouds([jnp.asarray(p) for p in pts], normals=[jnp.asarray(x) for x in nrm])
    np.testing.assert_array_equal(t.points_padded.numpy(), np.asarray(j.points_padded))
    np.testing.assert_array_equal(t.num_points_per_pointcloud.numpy(), np.asarray(j.num_points_per_pointcloud))
    for a, b in zip(t.normals_list, j.normals_list):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.has_normals and not t.has_colors and len(t) == 2
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (1.0, 2.0, 3.0)
    moved = t.transform(_t(T))
    np.testing.assert_allclose(moved.points_list[1].numpy(), pts[1] + T[:3, 3], rtol=1e-6)
    assert (moved.points_padded[0, 4:] == 0).all()  # padding stays zero
    both = t.append_points(t)
    assert both.num_points_per_pointcloud.tolist() == [8, 14]
    np.testing.assert_array_equal(both.points_list[0][4:].numpy(), pts[0])
    assert t[1].num_points_per_pointcloud.tolist() == [7]
    assert t.cpu().device.type == "cpu"
