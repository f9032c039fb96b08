"""The port's projective-association ICP against the JAX package.

The model image is frame 0 of the msrd clip (its global vertex and normal
maps and depth validity, at its true pose); the sources are the strided
global vertex map of frame 1. The association pixels, the linear system rows
and the gates are exact (same projection, one product per term); whole ICP
solves agree to 1e-5 in every transform entry (float32 sums in another
order; no association moves). A float64 gradcheck covers the gradLM solve's
gradient, which must also equal JAX's autodiff of its own solver.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.odometry.icputils as JI
import gradslam_tpu_torch.odometry.icputils as TI
from gradslam_tpu_torch.geometry import se3_exp, transform_pointcloud

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model_and_frame():
    gv = np.load(DATA / "global_vertex_map.npy").astype(np.float32)
    gn = np.load(DATA / "global_normal_map.npy").astype(np.float32)
    depth = np.load(DATA / "depths.npy")
    valid = (depth > 0)[..., 0].astype(np.float32)
    tgt_img = np.concatenate([gv[:, 0], gn[:, 0], valid[:, 0, ..., None]], -1).reshape(2, H * W, 7)
    return dict(
        tgt_img=np.ascontiguousarray(tgt_img),
        src=np.ascontiguousarray(gv[:, 1, ::4, ::4].reshape(2, -1, 3)),
        src_valid=np.ascontiguousarray(valid[:, 1, ::4, ::4].reshape(2, -1)),
        pose=np.load(DATA / "poses.npy").astype(np.float32)[:, 0],
        K=np.load(DATA / "intrinsics.npy").astype(np.float32),
    )


@pytest.mark.parametrize("kw", [dict(), dict(dist_thresh=0.0025, robust_delta=0.02)], ids=["plain", "gated"])
def test_gauss_newton_solve_projective_against_jax(model_and_frame, kw):
    m = model_and_frame
    j = JI.gauss_newton_solve_projective(
        jnp.asarray(m["src"]), jnp.asarray(m["tgt_img"]), jnp.asarray(m["pose"]), jnp.asarray(m["K"]),
        H, W, src_valid=jnp.asarray(m["src_valid"]), **kw,
    )
    t = TI.gauss_newton_solve_projective(
        _t(m["src"]), _t(m["tgt_img"]), _t(m["pose"]), _t(m["K"]), H, W,
        src_valid=_t(m["src_valid"]), **kw,
    )
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))  # association pixels
    for k in (0, 1):  # A and b
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    # weights: XLA may divide by multiplying with a reciprocal in the Huber
    # factor, which moves its last bit
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-6, atol=0)
    assert (t[2].numpy() > 0).sum() > 1000  # the gate keeps most pairs


@pytest.mark.parametrize("solver", ["point_to_plane_gradICP_projective", "point_to_plane_ICP_projective"])
def test_projective_icp_solvers_against_jax(model_and_frame, solver):
    m = model_and_frame
    kw = dict(numiters=10, dist_thresh=0.0025)
    j = getattr(JI, solver)(
        jnp.asarray(m["src"]), jnp.asarray(m["tgt_img"]), jnp.asarray(m["pose"]), jnp.asarray(m["K"]),
        H, W, src_valid=jnp.asarray(m["src_valid"]), **kw,
    )
    t = getattr(TI, solver)(
        _t(m["src"]), _t(m["tgt_img"]), _t(m["pose"]), _t(m["K"]), H, W,
        src_valid=_t(m["src_valid"]), **kw,
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    assert np.abs(t.numpy() - np.eye(4)).max() > 1e-4  # the solve moved


def _small_scene(dtype=np.float64):
    """A (1, 6*8, 7) model image of points on the pixel rays at random
    depths with random unit normals, and sources moved off it slightly."""
    rng = np.random.RandomState(5)
    h, w = 6, 8
    K = np.eye(4, dtype=dtype)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 5.0, 5.0, 3.5, 2.5
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = rng.uniform(1.5, 2.5, (h, w))
    pts = np.stack([(u - 3.5) / 5.0 * z, (v - 2.5) / 5.0 * z, z], -1).reshape(1, h * w, 3)
    nrm = rng.randn(1, h * w, 3) + np.array([0.0, 0.0, -3.0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tgt_img = np.concatenate([pts, nrm, np.ones((1, h * w, 1))], -1).astype(dtype)
    src = (pts + rng.uniform(-0.01, 0.01, pts.shape)).astype(dtype)
    return h, w, K[None, None], tgt_img, src


def test_projective_gradicp_gradcheck_float64():
    """Float64 gradcheck of the full projective gradICP solve w.r.t. the
    sources and the model image: autograd against central differences. The
    association pixels are piecewise constant and the perturbation is too
    small to move one."""
    h, w, K, tgt_img, src = _small_scene()
    pose = np.eye(4)[None]

    def loss(s, img):
        T = TI.point_to_plane_gradICP_projective(
            s, img, torch.from_numpy(pose), torch.from_numpy(K), h, w, numiters=4
        )
        return (T[:, :3, 3] ** 2).sum() + T[:, :3, :3].sum()

    s = torch.from_numpy(src).requires_grad_()
    img = torch.from_numpy(tgt_img).requires_grad_()
    assert torch.autograd.gradcheck(loss, (s, img), eps=1e-6, atol=1e-8, rtol=5e-4)
    with jax.enable_x64(True):
        def jloss(s_, img_):
            T = JI.point_to_plane_gradICP_projective(
                s_, img_, jnp.asarray(pose), jnp.asarray(K), h, w, numiters=4
            )
            return jnp.sum(T[:, :3, 3] ** 2) + jnp.sum(T[:, :3, :3])

        gs, gi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt_img))
    loss(s, img).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(img.grad.numpy(), np.asarray(gi), rtol=1e-6, atol=1e-10)


def test_projective_gradicp_recovers_known_transform():
    """Sources taken off the model image and moved by a small known motion:
    the solve brings them back."""
    h, w, K, tgt_img, _ = _small_scene(np.float32)
    pts = torch.from_numpy(tgt_img[..., 0:3])
    T_true = se3_exp(torch.tensor([[0.004, -0.003, 0.002, 0.003, -0.002, 0.004]]))
    src = transform_pointcloud(pts, T_true)
    T = TI.point_to_plane_gradICP_projective(
        src, torch.from_numpy(tgt_img), torch.eye(4)[None], torch.from_numpy(K), h, w, numiters=20
    )
    back = transform_pointcloud(src, T)
    assert (back - pts).abs().max() < 2e-3
