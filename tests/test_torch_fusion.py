"""gradslam_tpu_torch.slam.fusionutils against gradslam_tpu.slam.fusionutils.

One ``fusion_update_compact`` step runs from the same mid-sequence arena
(built by the JAX package, carried across as numpy) in both packages.
Integer outputs are exact: ``num_points``, the compacted active set, the
model image and which rows merged. Merged and appended floats agree to
rtol 2e-5: the confidence-weighted merge ``(c*m + a*f) / (c + a)`` may be
fused into multiply-adds by XLA and not by PyTorch.
"""

import pathlib

import jax
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


@pytest.fixture(scope="module")
def mid_sequence():
    """The JAX arena after fusing frames 0 and 1 at their true poses, and
    the derived maps of frame 2 at its true pose."""
    c = np.load(DATA / "colors.npy").astype(np.float32)
    d = np.load(DATA / "depths.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32)
    P = np.load(DATA / "poses.npy").astype(np.float32)
    opts = JS.SLAMOptions(odom="gt", fusion=True)
    st = JS.slam_init_state(jnp.asarray(c[:, 0]), jnp.asarray(d[:, 0]), jnp.asarray(K), opts,
                            3 * H * W, jnp.asarray(P[:, 0]))
    st = JS.slam_step_state(st, jnp.asarray(c[:, 1]), jnp.asarray(d[:, 1]), jnp.asarray(K), opts,
                            jnp.asarray(P[:, 1]))
    maps = JS._frame_maps(jnp.asarray(c[:, 2]), jnp.asarray(d[:, 2]), jnp.asarray(K), jnp.asarray(P[:, 2]))
    return dict(
        data=np.asarray(st.map_state.data), num_points=np.asarray(st.map_state.num_points),
        vm=np.asarray(maps[0]), gv=np.asarray(maps[2]), gn=np.asarray(maps[3]),
        valid=np.asarray(maps[4]), rgb=c[:, 2], pose=P[:, 2], K=K,
    )


def _args(ms, conv):
    return [conv(ms[k]) for k in ("gv", "gn", "vm", "rgb", "valid", "pose", "K")]


def test_fusion_step_matches_jax(mid_sequence):
    ms = mid_sequence
    A = 2 * H * W
    jstate = JMapState(jnp.asarray(ms["data"]), jnp.asarray(ms["num_points"]))
    jout, (jslot, jvalid, jimg) = JF.fusion_update_compact(
        jstate, *_args(ms, jnp.asarray), 0.05, 0.93969262, 0.6, A, return_active=True,
    )
    tstate = map_state_from_numpy(ms["data"], ms["num_points"], device="cpu")
    tout, (tslot, tvalid, timg) = TF.fusion_update_compact(
        tstate, *_args(ms, lambda x: torch.from_numpy(np.array(x))), 0.05, 0.93969262, 0.6, A,
        return_active=True,
    )
    np.testing.assert_array_equal(tout.num_points.numpy(), np.asarray(jout.num_points))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    jd, td = np.asarray(jout.data), tout.data.numpy()
    n0 = ms["num_points"]
    old = np.arange(jd.shape[1])[None, :] < n0[:, None]
    merged_j = old & np.any(jd != ms["data"], -1)
    merged_t = old & np.any(td != ms["data"], -1)
    np.testing.assert_array_equal(merged_t, merged_j)
    assert merged_j.sum() > 1000  # the step really merges
    assert (np.asarray(jout.num_points) > n0).all()  # and appends
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=1e-6)


def _lax_order(pix, cc, ray, slot):
    out = jax.vmap(lambda p, c, r, s: jax.lax.sort((p, -c, r, s), num_keys=4, is_stable=False))(
        jnp.asarray(pix), jnp.asarray(cc), jnp.asarray(ray), jnp.asarray(slot))
    return np.asarray(out[3])


def test_winner_order_is_jax_order_on_ties():
    """Crafted ties: many rows share a pixel, ccounts repeat (and one is
    -0.0 against 0.0), ray distances repeat; the slot settles the rest."""
    rng = np.random.default_rng(0)
    B, N = 2, 400
    pix = rng.integers(0, 7, (B, N)).astype(np.int32)
    pix[:, :50] = 9  # the 'no pixel' key past the last pixel
    cc = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32), (B, N))
    cc[0, :3] = 0.0
    ray = rng.choice(np.array([0.0, 1e-4, 2e-4, 3.0], np.float32), (B, N))
    slot = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    order = TF.winner_order(*(torch.from_numpy(x) for x in (pix, cc, ray, slot)))
    t_slots = np.take_along_axis(slot, order.numpy(), 1)
    np.testing.assert_array_equal(t_slots, _lax_order(pix, cc, ray, slot))
    ref = np.stack([slot[b][np.lexsort((slot[b], ray[b], -cc[b], pix[b]))] for b in range(B)])
    np.testing.assert_array_equal(t_slots, ref)


def test_winner_order_large_values():
    """Keys at the ends of their ranges keep their order when packed."""
    pix = np.array([[76800, 0, 0, 76799, 0]], np.int32)
    cc = np.array([[3.0, 1e30, 1e-7, 0.5, 1e30]], np.float32)
    ray = np.array([[0.0, 7e4, 0.0, 1e-30, 1e-30]], np.float32)
    slot = np.array([[2_000_000, 4, 1, 0, 3]], np.int32)
    order = TF.winner_order(*(torch.from_numpy(x) for x in (pix, cc, ray, slot)))
    np.testing.assert_array_equal(
        np.take_along_axis(slot, order.numpy(), 1), _lax_order(pix, cc, ray, slot)
    )


def test_aggregate_map_dense_matches_jax(mid_sequence):
    ms = mid_sequence
    jstate = JMapState(jnp.asarray(ms["data"]), jnp.asarray(ms["num_points"]))
    a = [ms[k] for k in ("gv", "gn", "vm", "rgb", "valid")]
    j = JF.aggregate_map_dense(jstate, *[jnp.asarray(x) for x in a], 0.6)
    t = TF.aggregate_map_dense(map_state_from_numpy(ms["data"], ms["num_points"], device="cpu"),
                               *[torch.from_numpy(np.array(x)) for x in a], 0.6)
    np.testing.assert_array_equal(t.num_points.numpy(), np.asarray(j.num_points))
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), rtol=2e-6, atol=1e-7)


def test_alpha_and_gates():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((2, 50, 3)).astype(np.float32)
    q = p + rng.standard_normal((2, 50, 3)).astype(np.float32) * 0.04
    np.testing.assert_allclose(TF.get_alpha(torch.from_numpy(p), 0.6).numpy(),
                               np.asarray(JF.get_alpha(jnp.asarray(p), 0.6)), rtol=1e-6)
    np.testing.assert_array_equal(
        TF.are_points_close(torch.from_numpy(p), torch.from_numpy(q), 0.05).numpy(),
        np.asarray(JF.are_points_close(jnp.asarray(p), jnp.asarray(q), 0.05)))
    np.testing.assert_array_equal(
        TF.are_normals_similar(torch.from_numpy(p), torch.from_numpy(q), 0.9).numpy(),
        np.asarray(JF.are_normals_similar(jnp.asarray(p), jnp.asarray(q), 0.9)))


def test_unported_paths_raise(mid_sequence):
    ms = mid_sequence
    tstate = map_state_from_numpy(ms["data"], ms["num_points"], device="cpu")
    args = _args(ms, lambda x: torch.from_numpy(np.array(x)))
    for kw in (dict(block_size=256), dict(assoc_window=1000), dict(dense_model_rows=True)):
        with pytest.raises(NotImplementedError):
            TF.fusion_update_compact(tstate, *args, 0.05, 0.9, 0.6, 100, **kw)
    with pytest.raises(NotImplementedError):
        TS.slam_step(tstate, torch.from_numpy(ms["pose"]), None, None, None,
                     TS.SLAMOptions(assoc="projective"))
