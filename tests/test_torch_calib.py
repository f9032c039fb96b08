"""The port's depth-calibration loss against the JAX package, and its
training loop on the CPU.

``slam_loss`` runs ``examples/train_depth_calib.py``'s configuration (the
golden clip at half size, B=1, gradicp with 5 iterations, exact fusion) in
both packages from the same numpy inputs, with the parameters carried
across by ``depth_calib_from_numpy``. Tolerances: the loss within 1e-3 of
its value and the gradient within 1e-3 of its largest component. The loss
is the mean square of position errors of ~5e-5 m, so float32 rounding of
the poses moves it relatively more than it moves them: the measured gaps
are up to 1.8e-4 in the loss and 2e-4 in the gradient.

On the clip cycled to L=10 at full width (B=2, ``PointFusion()`` defaults,
where frame 3 jumps back to frame 0), both packages' d/d(scale) change sign
above the true scale: at 1.1286 both point away from 1.1, at 1.1554 both
toward it. The loss there is the square of ~4e-5 m position errors, so the
port is held to what a 1e-6 m difference in the positions can make (the
measured gap is 1.25e-11 on a loss of 1.84e-9, 0.68%), the gradient's sign
exactly and its value within 1e-2 (measured 0.41%).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.parallel import sharded as JP
from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch.parallel import DepthCalibParams, depth_calib_from_numpy, slam_loss
from gradslam_tpu_torch.slam import icpslam as TS

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
TRUE_SCALE = 1.1


@pytest.fixture(scope="module")
def half_clip():
    """train_depth_calib.py's inputs: batch entry 0 at half resolution, the
    intrinsics scaled with it, and the depth a sensor with scale 1/1.1 sees."""
    colors = np.load(DATA / "colors.npy")[:1, :, ::2, ::2].astype(np.float32)
    depths = np.load(DATA / "depths.npy")[:1, :, ::2, ::2].astype(np.float32)
    K = np.load(DATA / "intrinsics.npy")[:1].astype(np.float32).copy()
    K[:, :, :2] *= 0.5
    return colors, depths, (depths / TRUE_SCALE).astype(np.float32), K


def _opts(mod):
    return mod.SLAMOptions(odom="gradicp", numiters=5, fusion=True)


def _gt_poses(colors, depths, K):
    L, H, W = colors.shape[1:4]
    with torch.no_grad():
        _, poses = TS.slam_sequence(torch.from_numpy(colors), torch.from_numpy(depths), torch.from_numpy(K),
                                    None, _opts(TS), L * H * W)
    return poses


def test_depth_calib_params():
    p = DepthCalibParams(device="cpu")
    assert p.scale.item() == 1.0 and p.bias.item() == 0.0
    assert [n for n, _ in p.named_parameters()] == ["scale", "bias"]
    p = depth_calib_from_numpy(np.float32(1.25), np.float32(0.5), device="cpu")
    depth = torch.tensor([0.0, 2.0])
    torch.testing.assert_close(p(depth), torch.tensor([0.0, 3.0]))


@pytest.mark.parametrize("scale,bias", [(1.0, 0.0), (1.05, 0.01)])
def test_slam_loss_value_and_grad_match_jax(half_clip, scale, bias):
    colors, clean, observed, K = half_clip
    L, H, W = colors.shape[1:4]
    cap = L * H * W
    _, gt_j = JS.slam_sequence(jnp.asarray(colors), jnp.asarray(clean), jnp.asarray(K), None, _opts(JS), cap)
    jparams = JP.DepthCalibParams(scale=jnp.asarray(scale, jnp.float32), bias=jnp.asarray(bias, jnp.float32))
    loss_j, grad_j = jax.value_and_grad(JP.slam_loss)(
        jparams, jnp.asarray(colors), jnp.asarray(observed), jnp.asarray(K), gt_j, _opts(JS), cap
    )
    params = depth_calib_from_numpy(np.asarray(jparams.scale), np.asarray(jparams.bias), device="cpu")
    loss = slam_loss(params, torch.from_numpy(colors), torch.from_numpy(observed), torch.from_numpy(K),
                     torch.from_numpy(np.array(gt_j)), _opts(TS), cap)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    gj = np.array([float(grad_j.scale), float(grad_j.bias)])
    gt = np.array([float(params.scale.grad), float(params.bias.grad)])
    assert np.all(gj != 0) and np.abs(gt - gj).max() <= 1e-3 * np.abs(gj).max(), (gt, gj)


def test_calibration_loop_recovers_the_scale(half_clip):
    """train_depth_calib.py's loop: 30 steps from scale 1.0, lr 0.05 halved
    every 10, the step normalized by |grad|, bias fixed. The scale ends
    within 0.01 of the true 1.1."""
    colors, clean, observed, K = half_clip
    L, H, W = colors.shape[1:4]
    gt = _gt_poses(colors, clean, K)
    params = DepthCalibParams(device="cpu")
    rgb, depth, Kt = torch.from_numpy(colors), torch.from_numpy(observed), torch.from_numpy(K)
    steps = 30
    losses = []
    for i in range(steps):
        lr = 0.05 * 0.5 ** (i / (steps / 3))
        params.zero_grad()
        loss = slam_loss(params, rgb, depth, Kt, gt, _opts(TS), L * H * W)
        loss.backward()
        losses.append(loss.item())
        with torch.no_grad():
            params.scale -= lr * params.scale.grad / (params.scale.grad.abs() + 1e-20)
    assert abs(params.scale.item() - TRUE_SCALE) <= 0.01, params.scale.item()
    assert params.bias.item() == 0.0
    assert losses[-1] < 0.01 * losses[0]


@pytest.fixture(scope="module")
def cycled_clip():
    """The golden clip cycled to L=10 at full width, the depth a sensor of
    scale 1/1.1 sees, and the JAX package's trajectory on the clean depths."""
    idx = [i % 3 for i in range(10)]
    colors = np.load(DATA / "colors.npy")[:, idx].astype(np.float32)
    depths = np.load(DATA / "depths.npy")[:, idx].astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32)
    L, H, W = colors.shape[1:4]
    _, gt = JS.slam_sequence(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), None,
                             JS.SLAMOptions(odom="gradicp", fusion=True), L * H * W)
    return colors, (depths / TRUE_SCALE).astype(np.float32), K, np.array(gt)


@pytest.mark.parametrize("scale", [1.10, 1.1286, 1.1554])
def test_cycled_clip_loss_and_gradient_sign_match_jax(cycled_clip, scale):
    colors, observed, K, gt = cycled_clip
    L, H, W = colors.shape[1:4]
    cap = L * H * W
    jparams = JP.DepthCalibParams(scale=jnp.asarray(scale, jnp.float32), bias=jnp.asarray(0.0, jnp.float32))
    loss_j, grad_j = jax.value_and_grad(JP.slam_loss)(
        jparams, jnp.asarray(colors), jnp.asarray(observed), jnp.asarray(K), jnp.asarray(gt),
        JS.SLAMOptions(odom="gradicp", fusion=True), cap,
    )
    params = depth_calib_from_numpy(np.float32(scale), np.float32(0.0), device="cpu")
    loss = slam_loss(params, torch.from_numpy(colors), torch.from_numpy(observed), torch.from_numpy(K),
                     torch.from_numpy(gt), TS.SLAMOptions(odom="gradicp", fusion=True), cap)
    loss.backward()
    lj, lt = float(loss_j), loss.item()
    gj, gt_ = float(grad_j.scale), float(params.scale.grad)
    if scale == TRUE_SCALE:
        # the minimum: both losses at float32's floor, the gradient noise
        assert lj < 1e-13 and lt < 1e-13, (lj, lt)
        return
    assert abs(lt - lj) <= 2 * np.sqrt(lj) * 1e-6, (lt, lj)
    assert np.sign(gt_) == np.sign(gj) and abs(gt_ - gj) <= 1e-2 * abs(gj), (gt_, gj)
    # the roughness is the input's: past 1.12 the sign changes from one scale to the next
    assert (gj < 0) == (scale == 1.1286), gj
