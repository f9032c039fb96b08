"""gradslam_tpu_torch.geometry against gradslam_tpu.geometry on the CPU.

The same random batches (numpy, fixed seed) go through the JAX function and
its port. Tolerance: rtol 1e-6 (a few float32 ulps): the two frameworks
may sum a 3- or 4-term product in another order or with a fused
multiply-add, which moves the last bit; the branches, guards and formulas
must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.geometry as JG
from gradslam_tpu.geometry.se3 import rt_matrix as jax_rt_matrix
import gradslam_tpu_torch.geometry as TG

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-6


def _both(fn_name, *arrays, **kw):
    j = getattr(JG, fn_name)(*[jnp.asarray(a) for a in arrays], **kw)
    t = getattr(TG, fn_name)(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    return j, t


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _poses(rng, n):
    xi = (rng.standard_normal((n, 6)) * 0.3).astype(np.float32)
    return np.asarray(JG.se3_exp(jnp.asarray(xi)))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("fn", ["homogenize_points", "normalize_quaternion",
                                "quaternion_to_axisangle", "quaternion_to_rotation_matrix",
                                "so3_hat", "so3_exp"])
def test_pointwise_functions(rng, fn):
    last = 4 if "quaternion" in fn else 3
    x = rng.standard_normal((3, 7, last)).astype(np.float32)
    _close(*_both(fn, x))


def test_unhomogenize_guard(rng):
    x = rng.standard_normal((2, 50, 4)).astype(np.float32)
    x[0, :5, -1] = 0.0  # degenerate w passes through unscaled
    x[1, :5, -1] = 1e-7
    j, t = _both("unhomogenize_points", x)
    _close(j, t)
    np.testing.assert_array_equal(t.numpy()[0, :5], x[0, :5, :3])


def test_project_points_z_guard(rng):
    pts = rng.standard_normal((2, 40, 3)).astype(np.float32)
    pts[:, :4, 2] = 0.0  # where(z != 0): no inf / nan
    K = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 525.0, 520.0, 80.0, 60.0
    j, t = _both("project_points", pts, K)
    assert np.isfinite(t.numpy()).all()
    _close(j, t)


def test_unproject_and_inverse_intrinsics(rng):
    K = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 525.0, 520.0, 80.0, 60.0
    j, t = _both("inverse_intrinsics", K)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # 1/(f+1e-6) terms
    pix = rng.uniform(0, 160, (2, 30, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (2, 30)).astype(np.float32)
    _close(*_both("unproject_points", pix, np.asarray(j)[:, None], depth))


def test_project_points_to_pixels(rng):
    pts = np.concatenate(
        [rng.uniform(-1.5, 1.5, (2, 400, 2)), rng.uniform(-0.5, 4, (2, 400, 1))], -1
    ).astype(np.float32)
    valid = rng.random((2, 400)) > 0.2
    xi = (rng.standard_normal((2, 6)) * 0.05).astype(np.float32)
    pose = np.asarray(JG.se3_exp(jnp.asarray(xi)))
    K = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1, 1))
    K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2] = 100.0, 100.0, 80.0, 60.0
    j = JG.project_points_to_pixels(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose), jnp.asarray(K), 120, 160
    )
    t = TG.project_points_to_pixels(
        torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(np.array(pose)),
        torch.from_numpy(K), 120, 160,
    )
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t[0].dtype == torch.int32 and t[2].dtype == torch.bool


def test_create_meshgrid():
    for norm in (True, False):
        j = JG.create_meshgrid(5, 7, normalized_coords=norm)
        t = TG.create_meshgrid(5, 7, normalized_coords=norm)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fn", ["inverse_transformation", "se3_log"])
def test_transform_functions(rng, fn):
    _close(*_both(fn, _poses(rng, 6)))


@pytest.mark.parametrize("ortho", [True, False])
def test_compose_and_relative(rng, ortho):
    a, b = _poses(rng, 5), _poses(rng, 5)
    _close(*_both("compose_transformations", a, b))
    _close(*_both("relative_transformation", a, b, orthogonal_rotations=ortho))


def test_transform_pointcloud_and_normals(rng):
    T = _poses(rng, 2)
    pts = rng.standard_normal((2, 300, 3)).astype(np.float32)
    _close(*_both("transform_pointcloud", pts, T))
    _close(*_both("transform_normals", pts, T))


def test_se3_exp_branches(rng):
    xi = (rng.standard_normal((8, 6)) * 0.2).astype(np.float32)
    xi[:3, 3:] = rng.standard_normal((3, 3)).astype(np.float32) * 1e-8  # small-angle branch
    xi[3, 3:] = 0.0
    j, t = _both("se3_exp", xi)
    _close(j, t)
    # small angle: R and V are both I + hat(omega)
    hat = TG.so3_hat(torch.from_numpy(xi[:4, 3:]))
    eye = torch.eye(3)
    np.testing.assert_allclose(t[:4, :3, :3].numpy(), (eye + hat).numpy(), rtol=0, atol=1e-7)
    v = torch.from_numpy(xi[:4, :3])
    np.testing.assert_allclose(
        t[:4, :3, 3].numpy(), ((eye + hat) @ v[..., None])[..., 0].numpy(), rtol=0, atol=1e-7
    )


def test_se3_hat_and_rt_matrix(rng):
    xi = rng.standard_normal((4, 6)).astype(np.float32)
    _close(*_both("se3_hat", xi))
    R = rng.standard_normal((4, 3, 3)).astype(np.float32)
    t = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TG.rt_matrix(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
        np.asarray(jax_rt_matrix(jnp.asarray(R), jnp.asarray(t))),
    )
