"""Block-gated fusion (``block_size``): the port against the JAX package.

``visible_subarena`` runs on the same mid-sequence arena (the JAX package's,
carried across as numpy) in both packages, at block sizes 512 and 700 (which
does not divide the capacity) and at poses that put blocks behind the
camera: the visible slots and live mask are exactly equal and the gathered
rows bit-equal. A gated fusion step is held against JAX's gated step and
against the port's ungated step, as ``TestBlockGating`` holds the JAX
package: ``num_points`` and the integer outputs equal, data within 1e-6 of
the ungated step's and within 1e-6 plus 1e-6 of the value of JAX's (colors
run to 255, where one float32 step is 1.5e-5, and XLA fuses the merge into
multiply-adds; the measured gap is 2.3e-7 of the value).
Gated sequences (``block_size`` 1024 on the msrd clip, 700 on an odd frame
size) give poses within 2e-4 of JAX's and the same ``num_points``.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.slam.fusionutils as JF
from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu.structures.maparena import MapState as JMapState
import gradslam_tpu_torch.slam.fusionutils as TF
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.structures.maparena import map_state_from_numpy

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160
DOT_TH = 0.93969262


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def arena():
    """The JAX arena (capacity 3*H*W) after fusing frame 0 at its true pose,
    and the derived maps of frame 1 at its true pose."""
    c = np.load(DATA / "colors.npy").astype(np.float32)
    d = np.load(DATA / "depths.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32)
    P = np.load(DATA / "poses.npy").astype(np.float32)
    opts = JS.SLAMOptions(odom="gt", fusion=True)
    st = JS.slam_init_state(jnp.asarray(c[:, 0]), jnp.asarray(d[:, 0]), jnp.asarray(K), opts,
                            3 * H * W, jnp.asarray(P[:, 0]))
    maps = JS._frame_maps(jnp.asarray(c[:, 1]), jnp.asarray(d[:, 1]), jnp.asarray(K), jnp.asarray(P[:, 1]))
    return dict(
        data=np.asarray(st.map_state.data), num_points=np.asarray(st.map_state.num_points),
        gv=np.asarray(maps[2]), gn=np.asarray(maps[3]), vm=np.asarray(maps[0]), rgb=c[:, 1],
        valid=np.asarray(maps[4]), pose=P[:, 1], K=K,
    )


def _moved(pose, degrees, offset):
    """``pose`` turned about its camera's y axis, then moved by ``offset``
    (x, y, z metres) in the turned camera's frame."""
    a = np.radians(degrees)
    R = np.eye(4, dtype=np.float32)
    R[0, 0], R[0, 2], R[2, 0], R[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    R[:3, 3] = offset
    return (pose @ R).astype(np.float32)


VIEWS = {
    "frame 1": (0.0, (0, 0, 0)),
    # every block behind or across the image plane: kept by the test's
    # conservative rule
    "turned 180 deg": (180.0, (0, 0, 0)),
    # the map beside the frustum, some blocks across it
    "0.6 m aside": (0.0, (0.6, 0, -0.5)),
    # the map in front, beside the frustum: every block culled
    "5 m aside": (0.0, (5.0, 0, -3.0)),
}


@pytest.mark.parametrize("block_size", [512, 700])
@pytest.mark.parametrize("view", list(VIEWS))
def test_visible_subarena_matches_jax(arena, block_size, view):
    pose = _moved(arena["pose"], *VIEWS[view])
    CAP = arena["data"].shape[1]
    NB = -(-CAP // block_size)
    jstate = JMapState(jnp.asarray(arena["data"]), jnp.asarray(arena["num_points"]))
    jd, js, jl = JF.visible_subarena(jstate, jnp.asarray(pose), jnp.asarray(arena["K"]), H, W, block_size, NB)
    tstate = map_state_from_numpy(arena["data"], arena["num_points"], device="cpu")
    td, ts, tl = TF.visible_subarena(tstate, _t(pose), _t(arena["K"]), H, W, block_size, NB)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    n_live = (arena["num_points"] + block_size - 1) // block_size
    n_vis = tl.numpy().reshape(2, NB, block_size).any(-1).sum(1)
    want = {"frame 1": n_live, "turned 180 deg": n_live, "5 m aside": 0 * n_live}.get(view)
    if want is None:
        assert ((0 < n_vis) & (n_vis < n_live)).all(), (n_vis, n_live)
    else:
        np.testing.assert_array_equal(n_vis, want)


def test_visible_capacity_keeps_the_lowest_blocks(arena):
    """Past ``visible_capacity`` blocks, the lowest-index visible ones are
    kept, as in JAX."""
    jstate = JMapState(jnp.asarray(arena["data"]), jnp.asarray(arena["num_points"]))
    tstate = map_state_from_numpy(arena["data"], arena["num_points"], device="cpu")
    j = JF.visible_subarena(jstate, jnp.asarray(arena["pose"]), jnp.asarray(arena["K"]), H, W, 512, 5)
    t = TF.visible_subarena(tstate, _t(arena["pose"]), _t(arena["K"]), H, W, 512, 5)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t[2].numpy().all()  # five full blocks of live rows


def _step_args(a, conv):
    return [conv(a[k]) for k in ("gv", "gn", "vm", "rgb", "valid", "pose", "K")]


def test_gated_step_matches_jax_and_ungated(arena):
    CAP = arena["data"].shape[1]
    A = 2 * H * W
    gate = dict(block_size=512, visible_capacity=-(-CAP // 512))
    jstate = JMapState(jnp.asarray(arena["data"]), jnp.asarray(arena["num_points"]))
    jout, jact = JF.fusion_update_compact(
        jstate, *_step_args(arena, jnp.asarray), 0.05, DOT_TH, 0.6, A, return_active=True, **gate
    )
    tstate = map_state_from_numpy(arena["data"], arena["num_points"], device="cpu")
    tout, tact = TF.fusion_update_compact(
        tstate, *_step_args(arena, _t), 0.05, DOT_TH, 0.6, A, return_active=True, **gate
    )
    ref = TF.fusion_update_compact(tstate, *_step_args(arena, _t), 0.05, DOT_TH, 0.6, A)
    np.testing.assert_array_equal(tout.num_points.numpy(), np.asarray(jout.num_points))
    np.testing.assert_array_equal(tout.num_points.numpy(), ref.num_points.numpy())
    for t, j in zip(tact, jact):  # candidates, validity, model image
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(tout.data.numpy(), np.asarray(jout.data), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tout.data.numpy(), ref.data.numpy(), atol=1e-6, rtol=0)
    merged = np.any(tout.data.numpy() != arena["data"], -1) & (
        np.arange(CAP)[None] < arena["num_points"][:, None])
    assert merged.sum() > 1000  # the step really merges


def test_gated_step_default_capacity_and_window_ignored(arena):
    """The default ``visible_capacity`` and an ``assoc_window``, which the
    gated path ignores, give JAX's step."""
    A = 2 * H * W
    jstate = JMapState(jnp.asarray(arena["data"]), jnp.asarray(arena["num_points"]))
    jout = JF.fusion_update_compact(jstate, *_step_args(arena, jnp.asarray), 0.05, DOT_TH, 0.6, A,
                                    block_size=1024, assoc_window=H * W)
    tstate = map_state_from_numpy(arena["data"], arena["num_points"], device="cpu")
    tout = TF.fusion_update_compact(tstate, *_step_args(arena, _t), 0.05, DOT_TH, 0.6, A,
                                    block_size=1024, assoc_window=H * W)
    np.testing.assert_array_equal(tout.num_points.numpy(), np.asarray(jout.num_points))
    np.testing.assert_allclose(tout.data.numpy(), np.asarray(jout.data), atol=1e-6, rtol=1e-6)


def _sequence(c, d, K, block_size, **kw):
    L, h, w = c.shape[1:4]
    opts = dict(odom="gradicp", fusion=True, block_size=block_size, **kw)
    mj, pj = JS.slam_sequence(jnp.asarray(c), jnp.asarray(d), jnp.asarray(K), None, JS.SLAMOptions(**opts),
                              L * h * w)
    mt, pt = TS.slam_sequence(_t(c), _t(d), _t(K), None, TS.SLAMOptions(**opts), L * h * w)
    assert np.isfinite(pt.numpy()).all()
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 2e-4
    np.testing.assert_array_equal(mt.num_points.numpy(), np.asarray(mj.num_points))
    return pt.numpy()


def test_gated_sequence_matches_jax():
    c = np.load(DATA / "colors.npy").astype(np.float32)
    d = np.load(DATA / "depths.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32)
    pt = _sequence(c, d, K, 1024, numiters=5)
    # and within the JAX package's gate of the ungated run
    _, pu = TS.slam_sequence(_t(c), _t(d), _t(K), None, TS.SLAMOptions(odom="gradicp", fusion=True, numiters=5),
                             3 * H * W)
    assert np.linalg.norm(pt[..., :3, 3] - pu.numpy()[..., :3, 3], axis=-1).max() < 5e-3


def test_block_size_700_odd_frame_matches_jax():
    """``tests/slam/test_slam.py``'s odd shapes: 45x61 frames, blocks of 700
    rows that do not divide the capacity."""
    rng = np.random.RandomState(1)
    B, L, h, w = 1, 2, 45, 61
    c = rng.rand(B, L, h, w, 3).astype(np.float32)
    d = (1.0 + 0.2 * rng.rand(B, L, h, w).astype(np.float32))[..., None]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 50.0
    K[0, 2], K[1, 2] = w / 2, h / 2
    _sequence(c, d, K[None, None], 700, numiters=2, dsratio=2)
