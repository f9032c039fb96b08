"""Public names of the JAX package that the port took last, each against its
JAX twin on seeded numpy inputs: ``geometryutils.cam2pixel`` and
``pixel2cam`` (within 1e-5 relative, 1e-5 absolute: a multiply-and-sum
against XLA's dot), ``MapState.from_arrays``, ``DepthCalibParams.init``,
``compact_masked``'s ``method`` and ``knn``'s ``use_pallas`` (all exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.geometry import geometryutils as jgu
from gradslam_tpu.ops.knn import knn as j_knn
from gradslam_tpu.ops.masking import compact_masked as j_compact_masked
from gradslam_tpu.parallel import DepthCalibParams as JParams
from gradslam_tpu.structures import MapState as JMapState
from gradslam_tpu_torch.geometry import geometryutils as gu
from gradslam_tpu_torch.ops import knn_reference
from gradslam_tpu_torch.ops.knn import knn, prepare_targets
from gradslam_tpu_torch.ops.masking import METHODS, compact_masked
from gradslam_tpu_torch.parallel import DepthCalibParams
from gradslam_tpu_torch.structures import MapState

TOL = dict(rtol=1e-5, atol=1e-5)


def _intrinsics(rng):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = rng.uniform(100, 600, 2)
    K[0, 2], K[1, 2] = rng.uniform(20, 320, 2)
    return K


@pytest.mark.parametrize("seed", [0, 1])
def test_cam2pixel_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cam = rng.randn(2, 6, 8, 3).astype(np.float32)
    cam[..., 2] = np.abs(cam[..., 2]) + 0.5
    cam[0, 0, 0, 2] = 0.0  # a point on the camera plane divides by 1
    proj = _intrinsics(rng)
    proj[:3, 3] = rng.randn(3)
    got = gu.cam2pixel(torch.from_numpy(cam), torch.from_numpy(proj)).numpy()
    ref = np.asarray(jgu.cam2pixel(jnp.asarray(cam), jnp.asarray(proj)))
    assert got.shape == (2, 6, 8, 2)
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match=r"\(\.\.\., 3\)"):
        gu.cam2pixel(torch.zeros(2, 4), torch.from_numpy(proj))


@pytest.mark.parametrize("depth_shape", [(5, 7), (5, 7, 1)])
def test_pixel2cam_matches_jax(depth_shape):
    rng = np.random.RandomState(2)
    kinv = np.linalg.inv(_intrinsics(rng)).astype(np.float32)
    pix = np.concatenate([rng.uniform(0, 60, (5, 7, 2)), np.ones((5, 7, 1))], -1).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, depth_shape).astype(np.float32)
    got = gu.pixel2cam(torch.from_numpy(depth), torch.from_numpy(kinv), torch.from_numpy(pix)).numpy()
    ref = np.asarray(jgu.pixel2cam(jnp.asarray(depth), jnp.asarray(kinv), jnp.asarray(pix)))
    np.testing.assert_allclose(got, ref, **TOL)
    assert "cam2pixel" in gu.__all__ and "pixel2cam" in gu.__all__


def test_map_state_from_arrays_matches_jax():
    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, 9, c).astype(np.float32) for c in (3, 3, 3, 1)]
    counts = np.array([4, 9], np.int32)
    got = MapState.from_arrays(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(counts))
    ref = JMapState.from_arrays(*(jnp.asarray(a) for a in arrays), jnp.asarray(counts))
    assert np.array_equal(got.data.numpy(), np.asarray(ref.data))
    assert np.array_equal(got.num_points.numpy(), np.asarray(ref.num_points))


def test_depth_calib_params_init_matches_jax():
    got, ref = DepthCalibParams.init(device="cpu"), JParams.init()
    assert isinstance(got, DepthCalibParams)
    for name in ("scale", "bias"):
        x = getattr(got, name)
        assert x.dtype == torch.float32 and x.requires_grad and x.device.type == "cpu"
        assert x.item() == float(getattr(ref, name))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("N, out_size", [(300, 64), (40_000, 25_000)])
def test_compact_masked_methods_match_jax(method, N, out_size):
    """Both sizes of the JAX 'auto' choice; the second overflows."""
    mask = np.random.RandomState(N).rand(2, N) < 0.7
    idx, valid = compact_masked(torch.from_numpy(mask), out_size, method=method)
    j_idx, j_valid = j_compact_masked(jnp.asarray(mask), out_size, method=method)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx)) and np.array_equal(valid.numpy(), np.asarray(j_valid))


def test_compact_masked_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="method must be one of"):
        compact_masked(torch.ones(1, 4, dtype=torch.bool), 2, method="radix")


@pytest.mark.parametrize("prepared", [False, True])
def test_knn_use_pallas(prepared):
    """None and False run the plain version on a CPU tensor, as JAX's
    ``use_pallas=False`` does; True asks for the CUDA kernel and raises
    (False on a card tensor raises too: tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(4)
    src = rng.randn(2, 50, 3).astype(np.float32)
    tgt = rng.randn(2, 70, 3).astype(np.float32)
    valid = rng.rand(2, 70) < 0.8
    s, t, v = (torch.from_numpy(x) for x in (src, tgt, valid))
    targets = prepare_targets(t, v) if prepared else t
    ref = knn_reference(s, t, v)
    jd, ji = j_knn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), use_pallas=False)
    for use_pallas in (None, False):
        d, i = knn(s, targets, None if prepared else v, use_pallas=use_pallas)
        assert torch.equal(d, ref[0]) and torch.equal(i, ref[1])
        assert np.array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="use_pallas=True"):
        knn(s, targets, None if prepared else v, use_pallas=True)
