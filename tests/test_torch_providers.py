"""The odometry providers and the downsample helpers: the port against the
JAX package, the six cases of ``tests/odometry/test_providers.py``.

Inputs are the msrd golden clip's frames. The ground-truth provider's
transform agrees with JAX's within 1e-6 and with the clip's poses within
1e-5; the ICP providers recover a known SE(3) within 5e-3, as the JAX
package's test holds them, and give JAX's transform within 1e-4 on the same
clouds. The downsampled clouds are equal (counts exactly, points within
2e-6, the global maps' tolerance in ``test_torch_structures.py``).
"""

import pathlib

import numpy as np
import pytest
import torch

import gradslam_tpu.odometry as JO
from gradslam_tpu.slam import find_active_map_points as j_find_active
from gradslam_tpu.structures import Pointclouds as JPointclouds, RGBDImages as JRGBDImages
from gradslam_tpu.structures.utils import pointclouds_from_rgbdimages as j_from_rgbd
import gradslam_tpu_torch.odometry as TO
from gradslam_tpu_torch.geometry import se3_exp
from gradslam_tpu_torch.slam import find_active_map_points
from gradslam_tpu_torch.structures import Pointclouds, RGBDImages, pointclouds_from_rgbdimages

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics", "poses")}


def _frame(clip, s, B=2, poses=True, pkg="torch"):
    args = [clip["colors"][:B, s : s + 1], clip["depths"][:B, s : s + 1], clip["intrinsics"][:B]]
    if poses:
        args.append(clip["poses"][:B, s : s + 1])
    return RGBDImages(*args, device="cpu") if pkg == "torch" else JRGBDImages(*args)


def test_ground_truth_relative_transform(clip):
    T = TO.GroundTruthOdometryProvider().provide(_frame(clip, 0), _frame(clip, 1))
    assert T.shape == (2, 1, 4, 4)
    Tj = JO.GroundTruthOdometryProvider().provide(_frame(clip, 0, pkg="jax"), _frame(clip, 1, pkg="jax"))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-6)
    expect = np.linalg.inv(clip["poses"][:, 0]) @ clip["poses"][:, 1]
    np.testing.assert_allclose(T[:, 0].numpy(), expect, atol=1e-5)


@pytest.mark.parametrize("bad", ["no poses", "sequence length 3"])
def test_ground_truth_refuses(clip, bad):
    if bad == "no poses":
        f = _frame(clip, 0, poses=False)
    else:
        f = RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], clip["poses"], device="cpu")
    with pytest.raises(ValueError):
        TO.GroundTruthOdometryProvider().provide(f, f)


def _cloud(clip):
    """Every 13th valid point of frame 0 (batch entry 0) with its normal."""
    pc = pointclouds_from_rgbdimages(_frame(clip, 0, B=1))
    n = int(pc.num_points_per_pointcloud[0])
    return pc.points_padded[0, :n][::13].numpy(), pc.normals_padded[0, :n][::13].numpy()


PROVIDERS = {"ICP": (TO.ICPOdometryProvider, JO.ICPOdometryProvider),
             "GradICP": (TO.GradICPOdometryProvider, JO.GradICPOdometryProvider)}


@pytest.mark.parametrize("provider", list(PROVIDERS))
def test_provide_recovers_transform(clip, provider):
    pts, nrm = _cloud(clip)
    T_true = se3_exp(torch.tensor([0.01, -0.01, 0.02, 0.05, -0.04, 0.03])).numpy()
    tgt_pts = pts @ T_true[:3, :3].T + T_true[:3, 3]
    tgt_nrm = nrm @ T_true[:3, :3].T
    t_cls, j_cls = PROVIDERS[provider]
    T = t_cls(numiters=20, dist_thresh=0.2).provide(
        Pointclouds(points=[torch.from_numpy(tgt_pts)], normals=[torch.from_numpy(tgt_nrm)]),
        Pointclouds(points=[torch.from_numpy(pts)], normals=[torch.from_numpy(nrm)]),
    )
    assert T.shape == (1, 1, 4, 4)
    np.testing.assert_allclose(T[0, 0].numpy(), T_true, atol=5e-3)
    Tj = j_cls(numiters=20, dist_thresh=0.2).provide(
        JPointclouds(points=[tgt_pts], normals=[tgt_nrm]), JPointclouds(points=[pts], normals=[nrm])
    )
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-4)


@pytest.mark.parametrize("provider", list(PROVIDERS))
@pytest.mark.parametrize("bad", ["no normals", "batch size mismatch"])
def test_provide_refuses(clip, provider, bad):
    pts, nrm = _cloud(clip)
    p, n = torch.from_numpy(pts), torch.from_numpy(nrm)
    if bad == "no normals":
        maps, frames = Pointclouds(points=[p]), Pointclouds(points=[p])
    else:
        maps, frames = Pointclouds(points=[p], normals=[n]), Pointclouds(points=[p, p], normals=[n, n])
    with pytest.raises(ValueError):
        PROVIDERS[provider][0]().provide(maps, frames)


@pytest.mark.parametrize("provider", list(PROVIDERS))
def test_providers_on_consecutive_frames_match_jax(clip, provider):
    """Frame 1 (every 4th pixel) onto frame 0's whole cloud, both from the
    RGB-D frames: the transform JAX gives, and near the clip's motion."""
    t_cls, j_cls = PROVIDERS[provider]
    T = t_cls().provide(pointclouds_from_rgbdimages(_frame(clip, 0)), TO.downsample_rgbdimages(_frame(clip, 1), 4))
    Tj = j_cls().provide(j_from_rgbd(_frame(clip, 0, pkg="jax")),
                         JO.downsample_rgbdimages(_frame(clip, 1, pkg="jax"), 4))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-4)
    assert np.abs(T[:, 0, :3, 3].numpy()).max() < 0.05  # frames 0 and 1 lie close


def test_downsample_rgbdimages_matches_jax(clip):
    t = TO.downsample_rgbdimages(_frame(clip, 1), 4)
    j = JO.downsample_rgbdimages(_frame(clip, 1, pkg="jax"), 4)
    np.testing.assert_array_equal(t.num_points_per_pointcloud.numpy(), np.asarray(j.num_points_per_pointcloud))
    for name in ("points_padded", "normals_padded", "colors_padded"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError):
        TO.downsample_rgbdimages(RGBDImages(clip["colors"], clip["depths"], clip["intrinsics"], device="cpu"), 4)


def test_downsample_pointclouds_matches_jax(clip):
    pc = pointclouds_from_rgbdimages(_frame(clip, 0))
    table = find_active_map_points(pc, _frame(clip, 1))
    t = TO.downsample_pointclouds(pc, table, 3)
    jpc = j_from_rgbd(_frame(clip, 0, pkg="jax"))
    j = JO.downsample_pointclouds(jpc, j_find_active(jpc, _frame(clip, 1, pkg="jax")), 3)
    np.testing.assert_array_equal(t.num_points_per_pointcloud.numpy(), np.asarray(j.num_points_per_pointcloud))
    assert 0 < int(t.num_points_per_pointcloud.min())
    for name in ("points_padded", "normals_padded", "colors_padded"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=2e-6, atol=2e-6)
