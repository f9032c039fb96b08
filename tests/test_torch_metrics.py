"""The port's trajectory and reconstruction metrics against the JAX package.

Each case of ``tests/metrics/test_trajectory.py`` and
``tests/metrics/test_reconstruction.py`` runs in both packages on the same
seeded numpy inputs: the port keeps the JAX test's own check, and its values
match the JAX function's within 1e-5 relative (1e-6 absolute where the value
is float noise around 0; 1e-5 rad for RPE's small angles, the arccos of a
float32 trace near 1). ``ate_rmse``'s gradient with respect to the
predicted poses matches ``jax.grad`` within 1e-5 of its largest component.

Where the gradient is undefined: the Umeyama alignment differentiates an
SVD of the 3x3 position covariance, whose backward divides by differences
of squared singular values. Trajectories here have L >= 5 positions in
general position (three distinct singular values). When two singular
values coincide, both frameworks return NaN gradients: positions on a line
(rank 1, a zero singular value twice), measured with L=2 and with L=4
below (at L=2 the aligned error is also exactly 0, where the square root's
derivative is infinite). Three positions in general position span a plane (rank 2, singular
values distinct); there both frameworks give finite gradients that agree
within 1e-7 (measured on the L=3 case below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu import metrics as JM
from gradslam_tpu_torch import metrics as TM
from gradslam_tpu_torch.geometry import se3_exp


def _close(port, ref, rtol=1e-5, atol=1e-6):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def random_trajectory(rng, L=20, scale=0.1):
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(L - 1):
        xi = torch.from_numpy(rng.randn(6).astype(np.float32) * scale)
        poses.append(poses[-1] @ se3_exp(xi).numpy())
    return np.stack(poses).astype(np.float32)


def _both(fn, *arrays, **kw):
    """``fn`` of the port and of the JAX package on the same numpy inputs."""
    port = getattr(TM, fn)(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw)
    ref = getattr(JM, fn)(*(jnp.asarray(a) for a in arrays), **kw)
    return port, ref


class TestUmeyama:
    def test_recovers_rigid_transform(self):
        rng = np.random.RandomState(0)
        src = rng.randn(30, 3).astype(np.float32)
        T = se3_exp(torch.tensor([0.3, -0.2, 0.5, 0.4, 0.1, -0.3])).numpy()
        dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        (R, t, s), (Rj, tj, sj) = _both("umeyama_alignment", src, dst)
        np.testing.assert_allclose(R.numpy(), T[:3, :3], atol=1e-4)
        np.testing.assert_allclose(t.numpy(), T[:3, 3], atol=1e-4)
        for port, ref in ((R, Rj), (t, tj), (s, sj)):
            _close(port, ref)

    def test_with_scale(self):
        rng = np.random.RandomState(1)
        src = rng.randn(30, 3).astype(np.float32)
        (R, t, s), (Rj, tj, sj) = _both("umeyama_alignment", src, src * 2.5, with_scale=True)
        np.testing.assert_allclose(float(s), 2.5, rtol=1e-4)
        for port, ref in ((R, Rj), (t, tj), (s, sj)):
            _close(port, ref)

    def test_reflection_fix(self):
        """dst a mirror image of src: the fix keeps R a rotation (det +1)."""
        rng = np.random.RandomState(8)
        src = rng.randn(30, 3).astype(np.float32)
        dst = src * np.array([1.0, 1.0, -1.0], np.float32)
        (R, t, s), (Rj, tj, sj) = _both("umeyama_alignment", src, dst)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
        for port, ref in ((R, Rj), (t, tj), (s, sj)):
            _close(port, ref)


class TestATE:
    def test_zero_for_identical(self):
        traj = random_trajectory(np.random.RandomState(2))
        port, ref = _both("ate_rmse", traj, traj)
        assert float(port) < 1e-6
        _close(port, ref)

    def test_invariant_to_rigid_offset(self):
        rng = np.random.RandomState(3)
        traj = random_trajectory(rng)
        offset = se3_exp(torch.tensor([1.0, 2.0, 3.0, 0.5, 0.2, 0.1])).numpy()
        moved = np.einsum("ij,ljk->lik", offset, traj).astype(np.float32)
        port, ref = _both("ate_rmse", moved, traj, align=True)
        assert float(port) < 1e-4
        _close(port, ref, atol=1e-5)

    @pytest.mark.parametrize("align,with_scale", [(True, False), (True, True), (False, False)])
    def test_nonzero_for_noisy(self, align, with_scale):
        rng = np.random.RandomState(4)
        traj = random_trajectory(rng)
        noisy = traj.copy()
        noisy[..., :3, 3] += rng.randn(*traj[..., :3, 3].shape).astype(np.float32) * 0.05
        port, ref = _both("ate_rmse", noisy, traj, align=align, with_scale=with_scale)
        assert 0.01 < float(port) < 0.2
        _close(port, ref)

    def test_batched(self):
        rng = np.random.RandomState(5)
        t1, t2 = random_trajectory(rng), random_trajectory(rng)
        noisy = np.stack([t1, t2])
        noisy[..., :3, 3] += rng.randn(2, 20, 3).astype(np.float32) * 0.05
        port, ref = _both("ate_rmse", noisy, np.stack([t1, t2]))
        assert port.shape == (2,)
        _close(port, ref)
        _close(port[1], TM.ate_rmse(torch.from_numpy(noisy[1]), torch.from_numpy(t2)))

    @pytest.mark.parametrize("L,with_scale", [(5, False), (5, True), (20, False), (20, True)])
    def test_gradient_matches_jax(self, L, with_scale):
        rng = np.random.RandomState(10 + L)
        gt = random_trajectory(rng, L)
        pred = gt.copy()
        pred[..., :3, 3] += rng.randn(L, 3).astype(np.float32) * 0.05
        gj = np.asarray(jax.grad(lambda p: JM.ate_rmse(p, jnp.asarray(gt), with_scale=with_scale))(
            jnp.asarray(pred)))
        p = torch.from_numpy(pred).requires_grad_(True)
        TM.ate_rmse(p, torch.from_numpy(gt), with_scale=with_scale).backward()
        assert np.isfinite(gj).all() and np.abs(gj).max() > 0
        assert np.abs(p.grad.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()

    def test_batched_gradient_matches_jax(self):
        rng = np.random.RandomState(9)
        gt = np.stack([random_trajectory(rng, 6), random_trajectory(rng, 6)])
        pred = gt.copy()
        pred[..., :3, 3] += rng.randn(2, 6, 3).astype(np.float32) * 0.05
        gj = np.asarray(jax.grad(lambda p: JM.ate_rmse(p, jnp.asarray(gt)).sum())(jnp.asarray(pred)))
        p = torch.from_numpy(pred).requires_grad_(True)
        TM.ate_rmse(p, torch.from_numpy(gt)).sum().backward()
        assert np.abs(p.grad.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()

    @pytest.mark.parametrize("case", ["L=2 on a line", "L=3 in a plane", "L=4 on a line"])
    def test_gradient_where_the_svd_degenerates(self, case):
        """The module docstring's cases: NaN in both frameworks where two
        singular values coincide, finite and equal where they do not."""
        lines = {
            "L=2 on a line": ([[0, 0, 0], [0, 1, 0]], [[0, 0, 0], [1, 0, 0]]),
            "L=3 in a plane": ([[0, 0, 0], [0, 1, 0], [0.3, 0, 0]], [[0, 0, 0], [1, 0, 0], [0, 0.2, 0]]),
            "L=4 on a line": ([[0, 0, 0], [0, 1, 0], [0, 2, 0], [0, 3.5, 0]],
                              [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]]),
        }
        pred, gt = (np.tile(np.eye(4, dtype=np.float32), (len(x), 1, 1)) for x in lines[case])
        pred[:, :3, 3], gt[:, :3, 3] = lines[case]
        gj = np.asarray(jax.grad(lambda p: JM.ate_rmse(p, jnp.asarray(gt)))(jnp.asarray(pred)))
        p = torch.from_numpy(pred).requires_grad_(True)
        TM.ate_rmse(p, torch.from_numpy(gt)).backward()
        if case == "L=3 in a plane":
            assert np.isfinite(gj).all() and np.abs(p.grad.numpy() - gj).max() <= 1e-7
        else:
            assert np.isnan(gj[:, :3, 3]).all() and torch.isnan(p.grad[:, :3, 3]).all()


class TestRPE:
    def test_zero_for_identical(self):
        traj = random_trajectory(np.random.RandomState(6))
        (t, r), (tj, rj) = _both("rpe", traj, traj)
        assert float(t) < 1e-6 and float(r) < 1e-3
        _close(t, tj)
        _close(r, rj, atol=1e-3)  # arccos near 1: float32 noise of ~1e-4 rad

    @pytest.mark.parametrize("delta", [1, 3])
    def test_detects_drift(self, delta):
        rng = np.random.RandomState(7)
        traj = random_trajectory(rng)
        drifted = traj.copy()
        for i in range(1, len(drifted)):
            drifted[i, :3, 3] += 0.01 * i
        drifted[:, :3, :3] = np.einsum("lij,jk->lik", drifted[:, :3, :3],
                                       se3_exp(torch.tensor([0, 0, 0, 0.01, 0, 0.02])).numpy()[:3, :3])
        (t, r), (tj, rj) = _both("rpe", drifted, traj, delta=delta)
        assert float(t) > 0.005
        _close(t, tj)
        # the angle is the arccos of a trace rounded in float32 near 1: its
        # rounding error is ~1e-7 / sin(angle), 3e-6 rad at this 5 mrad drift
        _close(r, rj, atol=1e-5)

    def test_batched(self):
        rng = np.random.RandomState(11)
        a, b = np.stack([random_trajectory(rng) for _ in range(2)]), np.stack([random_trajectory(rng) for _ in range(2)])
        t, r = TM.rpe(torch.from_numpy(a), torch.from_numpy(b))
        assert t.shape == r.shape == (2,)
        for i in range(2):
            tj, rj = JM.rpe(jnp.asarray(a[i]), jnp.asarray(b[i]))
            _close(t[i], tj)
            _close(r[i], rj)


class TestChamfer:
    def test_zero_for_identical(self):
        pts = np.random.RandomState(0).randn(2, 50, 3).astype(np.float32)
        port, ref = _both("chamfer_distance", pts, pts)
        np.testing.assert_allclose(port.numpy(), 0.0, atol=1e-5)
        _close(port, ref)

    def test_known_offset(self):
        a = np.zeros((1, 10, 3), np.float32)
        b = a.copy()
        b[..., 0] = 0.5
        port, ref = _both("chamfer_distance", a, b)
        np.testing.assert_allclose(port.numpy(), 0.5, atol=1e-5)  # 2*0.25
        _close(port, ref)

    def test_unsquared(self):
        a = np.zeros((1, 4, 3), np.float32)
        b = a.copy()
        b[..., 1] = 2.0
        port, ref = _both("chamfer_distance", a, b, squared=False)
        np.testing.assert_allclose(port.numpy(), 4.0, atol=1e-4)
        _close(port, ref)

    def test_validity_masks(self):
        a = np.array([[[0.0, 0, 0], [100.0, 0, 0]]], np.float32)
        b = np.array([[[0.0, 0, 0], [0.1, 0, 0]]], np.float32)
        port = TM.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b), valid_a=torch.tensor([[True, False]]))
        ref = JM.chamfer_distance(jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray([[True, False]]))
        assert float(port[0]) < 0.02
        _close(port, ref)

    @pytest.mark.parametrize("squared", [True, False])
    def test_random_clouds_with_masks(self, squared):
        rng = np.random.RandomState(12)
        a, b = rng.randn(2, 300, 3).astype(np.float32), rng.randn(2, 200, 3).astype(np.float32)
        va, vb = rng.rand(2, 300) > 0.3, rng.rand(2, 200) > 0.5
        port = TM.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(va),
                                   torch.from_numpy(vb), squared=squared)
        ref = JM.chamfer_distance(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
                                  squared=squared)
        _close(port, ref)


class TestMapAccuracy:
    def test_perfect_map(self):
        pts = np.random.RandomState(1).randn(1, 40, 3).astype(np.float32)
        (acc, comp), (accj, compj) = _both("map_accuracy", pts, pts)
        np.testing.assert_allclose(acc.numpy(), 1.0)
        np.testing.assert_allclose(comp.numpy(), 1.0)
        _close(acc, accj)
        _close(comp, compj)

    def test_partial_coverage(self):
        gt = np.stack([np.linspace(0, 1, 20), np.zeros(20), np.zeros(20)], -1).astype(np.float32)[None]
        (acc, comp), (accj, compj) = _both("map_accuracy", gt[:, :10], gt, threshold=0.02)
        np.testing.assert_allclose(acc.numpy(), 1.0)  # all map points on the gt
        assert 0.4 < float(comp[0]) < 0.7  # half the gt covered
        _close(acc, accj)
        _close(comp, compj)

    def test_random_clouds_with_masks(self):
        rng = np.random.RandomState(13)
        m, g = rng.randn(2, 300, 3).astype(np.float32), rng.randn(2, 250, 3).astype(np.float32)
        vm, vg = rng.rand(2, 300) > 0.2, rng.rand(2, 250) > 0.4
        port = TM.map_accuracy(torch.from_numpy(m), torch.from_numpy(g), torch.from_numpy(vm),
                               torch.from_numpy(vg), threshold=0.2)
        ref = JM.map_accuracy(jnp.asarray(m), jnp.asarray(g), jnp.asarray(vm), jnp.asarray(vg), threshold=0.2)
        for p, r in zip(port, ref):
            assert 0 < float(p.min()) and float(p.max()) < 1
            _close(p, r)
