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
