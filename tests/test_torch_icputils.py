"""gradslam_tpu_torch.odometry.icputils against gradslam_tpu.odometry.

The same inputs (the msrd clip, numpy batches from a fixed seed) go through
both solvers. The linear system rows are exact (same association, one
product per term); the 6x6 solves agree to rtol 1e-4 (LU in another
library, on a system whose damping is 1e-8); whole ICP solves to 1e-5 in
every transform entry (measured ~1e-8 on this clip: the float32 rounding
differences never move an association).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.odometry.icputils as JI
import gradslam_tpu_torch.odometry.icputils as TI
from gradslam_tpu_torch.geometry import se3_exp, transform_normals, transform_pointcloud

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame_pair():
    """Strided global vertex / normal maps of frames 1 (source) and 0
    (target) of both clips, with validity."""
    gv = np.load(DATA / "global_vertex_map.npy").astype(np.float32)
    gn = np.load(DATA / "global_normal_map.npy").astype(np.float32)
    depth = np.load(DATA / "depths.npy")
    take = lambda x, f: np.ascontiguousarray(x[:, f, ::4, ::4].reshape(2, -1, x.shape[-1]))
    return dict(
        src=take(gv, 1), src_valid=take(depth > 0, 1)[..., 0].astype(np.float32),
        tgt=take(gv, 0), tgt_n=take(gn, 0), tgt_valid=take(depth > 0, 0)[..., 0],
    )


def test_solve_linear_system_against_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 40, 6)).astype(np.float32)
    b = rng.standard_normal((3, 40, 1)).astype(np.float32)
    w = (rng.random((3, 40)) > 0.3).astype(np.float32)
    for damp in (1e-4, np.array([1e-3, 1e-2, 1.0], np.float32)):
        j = JI.solve_linear_system(jnp.asarray(A), jnp.asarray(b), jnp.asarray(damp), weights=jnp.asarray(w))
        t = TI.solve_linear_system(_t(A), _t(b), _t(damp) if np.ndim(damp) else damp, weights=_t(w))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lead", [(), (1,), (3,), (2, 3)])
def test_solve_linear_system_is_batch_invariant(lead):
    """Each batch element's solve gives the bits it gives alone, in any
    layout of the leading axes."""
    rng = np.random.default_rng(2)
    A = _t(rng.standard_normal(lead + (50, 6)).astype(np.float32))
    b = _t(rng.standard_normal(lead + (50, 1)).astype(np.float32))
    w = _t(rng.random(lead + (50,)).astype(np.float32))
    out = TI.solve_linear_system(A, b, 1e-3, weights=w)
    assert out.shape == lead + (6, 1)
    flat = out.reshape((-1, 6, 1))
    for i, (a, r, v) in enumerate(zip(A.reshape(-1, 50, 6), b.reshape(-1, 50, 1), w.reshape(-1, 50))):
        assert torch.equal(flat[i], TI.solve_linear_system(a[None], r[None], 1e-3, weights=v[None])[0])
    np.testing.assert_allclose(TI._sum_each(w, -1).numpy(), w.numpy().sum(-1), rtol=1e-5)


def test_solve_linear_system_recovers_solution():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((100, 6)).astype(np.float32)
    x = rng.standard_normal((6, 1)).astype(np.float32)
    out = TI.solve_linear_system(_t(A), _t(A @ x), damp=1e-8)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-3)


def test_gauss_newton_solve_against_jax(frame_pair):
    fp = frame_pair
    args_j = [jnp.asarray(fp[k]) for k in ("src", "tgt", "tgt_n")]
    args_t = [_t(fp[k]) for k in ("src", "tgt", "tgt_n")]
    for kw in (dict(), dict(dist_thresh=0.01, robust_delta=0.02)):
        j = JI.gauss_newton_solve(*args_j, src_valid=jnp.asarray(fp["src_valid"]),
                                  tgt_valid=jnp.asarray(fp["tgt_valid"]), **kw)
        t = TI.gauss_newton_solve(*args_t, src_valid=_t(fp["src_valid"]),
                                  tgt_valid=_t(fp["tgt_valid"]), **kw)
        for k in (0, 1, 3):  # A, b and the association: exact
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        # weights: XLA may divide by multiplying with a reciprocal in the
        # Huber factor, which moves its last bit
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-6, atol=0)


def test_huber_weights():
    r = np.array([0.01, -0.05, 0.5, 0.0, 0.3], np.float32)
    np.testing.assert_allclose(TI.huber_weights(_t(r), 0.1).numpy(),
                               np.asarray(JI.huber_weights(jnp.asarray(r), 0.1)), rtol=1e-6)


@pytest.mark.parametrize("solver", ["point_to_plane_gradICP", "point_to_plane_ICP"])
def test_icp_solvers_against_jax(frame_pair, solver):
    fp = frame_pair
    kw = dict(numiters=10)
    j = getattr(JI, solver)(
        jnp.asarray(fp["src"]), jnp.asarray(fp["tgt"]), jnp.asarray(fp["tgt_n"]),
        src_valid=jnp.asarray(fp["src_valid"]), tgt_valid=jnp.asarray(fp["tgt_valid"]), **kw,
    )
    t = getattr(TI, solver)(
        _t(fp["src"]), _t(fp["tgt"]), _t(fp["tgt_n"]),
        src_valid=_t(fp["src_valid"]), tgt_valid=_t(fp["tgt_valid"]), **kw,
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_gradicp_recovers_known_transform(frame_pair):
    src = _t(frame_pair["tgt"][:1, ::3])
    nrm = _t(frame_pair["tgt_n"][:1, ::3])
    T_true = se3_exp(torch.tensor([[0.01, -0.02, 0.015, 0.02, -0.01, 0.015]]))
    tgt = transform_pointcloud(src, T_true)
    T = TI.point_to_plane_gradICP(src, tgt, transform_normals(nrm, T_true), numiters=20)
    np.testing.assert_allclose(T.numpy(), T_true.numpy(), atol=2e-3)


def test_gradicp_gradcheck_float64():
    """Float64 gradcheck of the full gradICP solve, as the JAX package's
    test of its solver: autograd against central differences. The KNN
    indices are piecewise constant; the perturbation is too small to move
    an association."""
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.uniform(-1, 1, (1, 24, 3)))
    T_true = se3_exp(torch.tensor([0.02, -0.01, 0.015, 0.05, -0.04, 0.03], dtype=torch.float64))
    tgt = transform_pointcloud(src, T_true[None])
    nrm = rng.randn(1, 24, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tgt_nrm = transform_normals(torch.from_numpy(nrm), T_true[None])

    def loss(s):
        T = TI.point_to_plane_gradICP(s, tgt, tgt_nrm, numiters=4)
        return (T[:, :3, 3] ** 2).sum() + T[:, :3, :3].sum()

    assert torch.autograd.gradcheck(loss, (src.clone().requires_grad_(),), eps=1e-6, atol=1e-8, rtol=5e-4)
    # and the same gradient as JAX's autodiff of its own solver
    with jax.enable_x64(True):
        def jloss(s):
            T = JI.point_to_plane_gradICP(s, jnp.asarray(tgt.numpy()), jnp.asarray(tgt_nrm.numpy()), numiters=4)
            return jnp.sum(T[:, :3, 3] ** 2) + jnp.sum(T[:, :3, :3])

        gj = np.asarray(jax.grad(jloss)(jnp.asarray(src.numpy())))
    s = src.clone().requires_grad_()
    loss(s).backward()
    np.testing.assert_allclose(s.grad.numpy(), gj, rtol=1e-6, atol=1e-10)


def test_frame_points_from_maps():
    rng = np.random.default_rng(4)
    maps = [rng.standard_normal((2, 1, 12, 16, 3)).astype(np.float32) for _ in range(3)]
    valid = rng.random((2, 1, 12, 16, 1)) > 0.5
    j = JI.frame_points_from_maps(*[jnp.asarray(m) for m in maps], jnp.asarray(valid), 4)
    t = TI.frame_points_from_maps(*[_t(m) for m in maps], _t(valid), 4)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
