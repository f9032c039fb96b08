"""The port's sharded SLAM, sharded training step and pipeline against the
JAX package's (mirrors tests/parallel/test_sharded.py and
tests/parallel/test_pipeline.py).

The port's ranks are gloo processes on the CPU (``tests/torch_dist_worker.py``:
four for ``make_mesh(data=2, map_=2)`` and a 4-shard map, two for the
training step and the pipeline); the JAX side runs here on the virtual CPU
devices that ``tests/conftest.py`` sets up. Inputs: the golden clip
``tests/data/msrd_b2s3`` strided 2x or 4x. Tolerances: ``sharded_slam``
poses and arena within 1e-4 of JAX's with ``num_points`` equal, and
bit-equal to the port's own single-process run, for the full-arena options
and for each mapping option of ``MAP_AXIS_OPTIONS`` under the map axis (held
against JAX's single-process ``slam_sequence``); the training step's losses
and parameters within 1e-4 relative of JAX's single-process step over 'data'
and over (data, map), and under the map axis its move at a larger learning
rate within 1e-4 relative of JAX's gradient times that rate; the
pipeline's poses rtol 1e-5 atol 1e-6 and arena rtol 1e-5 atol 1e-4, the
JAX test's, and bit-equal to the port's single-process run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradslam_tpu.parallel import DepthCalibParams as JParams
from gradslam_tpu.parallel import make_mesh as j_make_mesh
from gradslam_tpu.parallel.pipeline import pipeline_mesh as j_pipeline_mesh
from gradslam_tpu.parallel.pipeline import pipelined_slam_sequence as j_pipelined
from gradslam_tpu.parallel.sharded import sharded_slam as j_sharded_slam
from gradslam_tpu.parallel.sharded import slam_loss as j_slam_loss
from gradslam_tpu.slam.icpslam import SLAMOptions as JOpts
from gradslam_tpu.slam.icpslam import slam_sequence as j_slam_sequence
from tests.torch_dist_worker import (
    MAP_AXIS_CAPACITY,
    MAP_AXIS_OPTIONS,
    PIPE_OPTS,
    SHARDED_OPTS,
    TRAIN,
    TRAIN_MOVE_LR,
    golden_clip,
    launch,
)


@pytest.fixture(scope="module")
def sharded4(tmp_path_factory):
    return launch("sharded4", 4, tmp_path_factory.mktemp("sharded4"))


@pytest.fixture(scope="module")
def pair2(tmp_path_factory):
    return launch("pair2", 2, tmp_path_factory.mktemp("pair2"))


@pytest.fixture(scope="module")
def jax_train():
    """JAX's single-process SGD steps (TRAIN) on the 4x-strided clip: the
    losses, parameters after each step and the first step's gradient."""
    rgb, dep, K, gt = (jnp.asarray(x) for x in golden_clip(4))
    B, L, H, W, _ = rgb.shape
    opts = JOpts(**TRAIN["opts"])
    grad_fn = jax.jit(jax.value_and_grad(j_slam_loss), static_argnames=("opts", "capacity"))
    params = JParams(scale=jnp.asarray(TRAIN["scale"]), bias=jnp.asarray(TRAIN["bias"]))
    out = {"loss": [], "scale": [], "bias": []}
    for i in range(TRAIN["steps"]):
        loss, g = grad_fn(params, rgb, dep, K, gt, opts=opts, capacity=L * H * W)
        if i == 0:
            out["grad"] = [float(g.scale), float(g.bias)]
        params = jax.tree_util.tree_map(lambda p, gg: p - TRAIN["lr"] * gg, params, g)
        out["loss"].append(float(loss))
        out["scale"].append(float(params.scale))
        out["bias"].append(float(params.bias))
    return out


def test_sharded_slam_matches_jax(sharded4):
    colors, depths, K, _ = golden_clip(2)
    B, L, H, W, _ = colors.shape
    mesh = j_make_mesh(data=2, map_=2, devices=jax.devices()[:4])
    m, p = j_sharded_slam(mesh, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), None,
                          JOpts(**SHARDED_OPTS), L * H * W)
    got = sharded4.wait()[0]
    np.testing.assert_allclose(got["poses"], np.asarray(p), atol=1e-4)
    np.testing.assert_array_equal(got["num_points"], np.asarray(m.num_points))
    np.testing.assert_allclose(got["data"], np.asarray(m.data), atol=1e-4)


def test_map_shards_are_partitioned_and_bit_equal(sharded4):
    """Each rank holds a (B/2, CAP/2, 12) shard, ranks laid out row-major;
    the assembled arena and poses equal the port's single-process run bit
    for bit, at map=2 and at map=4 (where the fusion steps select among the
    rows of several shards)."""
    colors, _, _, _ = golden_clip(2)
    B, L, H, W, _ = colors.shape
    res = sharded4.wait()
    for r, got in enumerate(res):
        assert tuple(got["coords"]) == (r // 2, r % 2)
        assert tuple(got["shard_shape"]) == (B // 2, L * H * W // 2, 12)
        assert tuple(got["map4_shard_shape"]) == (B, H * W, 12)
        assert bool(got["roundtrip"])
        np.testing.assert_array_equal(got["data"], res[0]["data"])
    r0 = res[0]
    np.testing.assert_array_equal(r0["num_points"], r0["ref_num_points"])
    assert np.array_equal(r0["poses"], r0["ref_poses"]) and np.array_equal(r0["data"], r0["ref_data"])
    assert bool(r0["map4_bitequal"])
    np.testing.assert_array_equal(r0["map4_num_points"], r0["map4_ref_num_points"])
    # the 4-shard run's map spans more than one shard
    assert (r0["map4_num_points"] > H * W).all()


@pytest.mark.parametrize("name", [*MAP_AXIS_OPTIONS, "train"])
def test_map_axis_option_matches_jax(sharded4, jax_train, name):
    """Each mapping option under make_mesh(data=2, map_=2), and the training
    step over it, against JAX's single-process run."""
    res = sharded4.wait()
    if name == "train":
        for got in res:
            np.testing.assert_allclose(got["train_map_loss"], jax_train["loss"], rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(got["train_map_scale"], jax_train["scale"], rtol=1e-4)
            np.testing.assert_allclose(got["train_map_bias"], jax_train["bias"], rtol=1e-4, atol=1e-7)
            np.testing.assert_array_equal(got["train_map_move"], res[0]["train_map_move"])
        # the move at a larger rate: a gradient counted once, not once per map rank
        move = np.array([TRAIN["scale"], TRAIN["bias"]], np.float32) - res[0]["train_map_move"]
        np.testing.assert_allclose(move, TRAIN_MOVE_LR * np.array(jax_train["grad"]), rtol=1e-4)
        assert (move != 0).all(), "zero gradient"
        return
    colors, depths, K, _ = golden_clip(2)
    opts = JOpts(**dict(SHARDED_OPTS, **MAP_AXIS_OPTIONS[name]))
    m, p = j_slam_sequence(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), None, opts, MAP_AXIS_CAPACITY)
    B = colors.shape[0]
    for got in res:
        assert tuple(got[f"{name}_shard_shape"]) == (B // 2, MAP_AXIS_CAPACITY // 2, 12)
    r0 = res[0]
    assert bool(r0[f"{name}_bitequal"]), f"{name}: not bit-equal to the port's single-process run"
    np.testing.assert_array_equal(r0[f"{name}_num_points"], np.asarray(m.num_points))
    np.testing.assert_allclose(r0[f"{name}_poses"], np.asarray(p), atol=1e-4)
    np.testing.assert_allclose(r0[f"{name}_data"], np.asarray(m.data), atol=1e-4)
    # live rows on both map ranks
    assert (r0[f"{name}_num_points"] > MAP_AXIS_CAPACITY // 2).any()


def test_sharded_train_step_matches_jax(pair2, jax_train):
    res = pair2.wait()
    for got in res:
        np.testing.assert_allclose(got["train_loss"], jax_train["loss"], rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(got["train_scale"], jax_train["scale"], rtol=1e-4)
        np.testing.assert_allclose(got["train_bias"], jax_train["bias"], rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(got["train_scale"], res[0]["train_scale"])
    assert jax_train["scale"][-1] != TRAIN["scale"] and res[0]["train_scale"][-1] != TRAIN["scale"], "zero gradient"


@pytest.mark.parametrize("assoc", ["knn", "projective"])
def test_pipelined_matches_jax(pair2, assoc):
    rgb, dep, K, _ = (jnp.asarray(x) for x in golden_clip(2, frames=(0, 1, 2, 1)))
    B, L, H, W, _ = rgb.shape
    m, p = j_pipelined(rgb, dep, K, JOpts(**dict(PIPE_OPTS, assoc=assoc)), L * H * W, mesh=j_pipeline_mesh())
    res = pair2.wait()
    for got in res:
        np.testing.assert_allclose(got[f"pipe_{assoc}_poses"], np.asarray(p), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[f"pipe_{assoc}_num_points"], np.asarray(m.num_points))
        np.testing.assert_allclose(got[f"pipe_{assoc}_data"], np.asarray(m.data), rtol=1e-5, atol=1e-4)
    assert bool(res[1][f"pipe_{assoc}_bitequal"])
    np.testing.assert_array_equal(res[0][f"pipe_{assoc}_data"], res[1][f"pipe_{assoc}_data"])


def test_pipeline_rejects_gt_and_short():
    import torch

    from gradslam_tpu_torch.parallel import pipelined_slam_sequence
    from gradslam_tpu_torch.slam import SLAMOptions

    rgb = torch.zeros((1, 1, 8, 8, 3))
    dep = torch.ones((1, 1, 8, 8, 1))
    K = torch.eye(4).expand(1, 1, 4, 4)
    with pytest.raises(ValueError, match="gt"):
        pipelined_slam_sequence(rgb, dep, K, SLAMOptions(odom="gt"), 64)
    with pytest.raises(ValueError, match="2 frames"):
        pipelined_slam_sequence(rgb, dep, K, SLAMOptions(odom="gradicp", fusion=True), 64)
