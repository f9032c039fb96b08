"""The port's capacity-windowed fusion and model rows against the JAX package.

One ``fusion_update_compact`` step runs from the same mid-sequence arena
(built by the JAX package, carried across as numpy) in both packages, for
each formulation of the windowed merge ('dense' with the view compacted or
not, active or gated compaction, a buffer that overflows; 'rows' with and
without compaction) and for the exact path's model rows. Integer outputs are
exact: ``num_points``, the compacted set, the model image, which rows
merged, the model rows' valid channel. Floats agree to rtol 2e-5: the
confidence-weighted merge ``(c*m + a*f) / (c + a)`` may be fused into
multiply-adds by XLA and not by PyTorch.
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
from gradslam_tpu_torch.structures.maparena import init_map, map_state_from_numpy

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160
HW = H * W
DOT_TH = 0.93969262


@pytest.fixture(scope="module")
def mid_sequence():
    """The JAX arena (CAP = 4*H*W) after fusing frames 0 and 1 at their true
    poses, and the derived maps of frame 2 at its true pose."""
    c = np.load(DATA / "colors.npy").astype(np.float32)
    d = np.load(DATA / "depths.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32)
    P = np.load(DATA / "poses.npy").astype(np.float32)
    opts = JS.SLAMOptions(odom="gt", fusion=True)
    st = JS.slam_init_state(jnp.asarray(c[:, 0]), jnp.asarray(d[:, 0]), jnp.asarray(K), opts,
                            4 * HW, jnp.asarray(P[:, 0]))
    st = JS.slam_step_state(st, jnp.asarray(c[:, 1]), jnp.asarray(d[:, 1]), jnp.asarray(K), opts,
                            jnp.asarray(P[:, 1]))
    maps = JS._frame_maps(jnp.asarray(c[:, 2]), jnp.asarray(d[:, 2]), jnp.asarray(K), jnp.asarray(P[:, 2]))
    return dict(
        data=np.asarray(st.map_state.data), num_points=np.asarray(st.map_state.num_points),
        vm=np.asarray(maps[0]), gv=np.asarray(maps[2]), gn=np.asarray(maps[3]),
        valid=np.asarray(maps[4]), rgb=c[:, 2], pose=P[:, 2], K=K, c=c, d=d, P=P,
    )


def _args(ms, conv):
    return [conv(ms[k]) for k in ("gv", "gn", "vm", "rgb", "valid", "pose", "K")]


def _t(x):
    return torch.from_numpy(np.array(x))


def _step_both(ms, A, **kw):
    jstate = JMapState(jnp.asarray(ms["data"]), jnp.asarray(ms["num_points"]))
    jout, jact = JF.fusion_update_compact(
        jstate, *_args(ms, jnp.asarray), 0.05, DOT_TH, 0.6, A, return_active=True, **kw
    )
    tstate = map_state_from_numpy(ms["data"], ms["num_points"], device="cpu")
    tout, tact = TF.fusion_update_compact(
        tstate, *_args(ms, _t), 0.05, DOT_TH, 0.6, A, return_active=True, **kw
    )
    return (jout, jact), (tout, tact)


def _assert_step_equal(ms, j, t):
    (jout, jact), (tout, tact) = j, t
    np.testing.assert_array_equal(tout.num_points.numpy(), np.asarray(jout.num_points))
    assert len(tact) == len(jact)
    for a, b in zip(jact[:3], tact[:3]):  # compacted set and model image: exact
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if len(jact) == 4:
        jr, tr = np.asarray(jact[3]), tact[3].numpy()
        np.testing.assert_array_equal(tr[..., 6], jr[..., 6])
        np.testing.assert_allclose(tr, jr, rtol=2e-5, atol=1e-6)
    jd, td = np.asarray(jout.data), tout.data.numpy()
    old = np.arange(jd.shape[1])[None, :] < ms["num_points"][:, None]
    merged_j = old & np.any(jd != ms["data"], -1)
    np.testing.assert_array_equal(old & np.any(td != ms["data"], -1), merged_j)
    assert merged_j.sum() > 1000  # the step really merges
    assert (np.asarray(jout.num_points) > ms["num_points"]).all()  # and appends
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=1e-6)


# (assoc_window, active_capacity, need_active_set, dense_model_rows)
DENSE_CASES = {
    "direct-window": (2 * HW, 2 * HW, True, True),
    "direct-window-gated": (2 * HW, 2 * HW, False, False),
    "compacted-active": (3 * HW, 2 * HW, True, False),
    "compacted-gated": (3 * HW, 2 * HW, False, True),
    "compacted-active-overflow": (3 * HW, HW // 2, True, True),
    "compacted-gated-overflow": (3 * HW, HW // 4, False, False),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_window_step_matches_jax(mid_sequence, case):
    win, A, need_active, dense_rows = DENSE_CASES[case]
    j, t = _step_both(mid_sequence, A, assoc_window=win, window_merge="dense",
                      need_active_set=need_active, dense_model_rows=dense_rows)
    _assert_step_equal(mid_sequence, j, t)


@pytest.mark.parametrize("win,dense_rows", [(2 * HW, True), (3 * HW, False)], ids=["direct", "compacted"])
def test_rows_window_step_matches_jax(mid_sequence, win, dense_rows):
    j, t = _step_both(mid_sequence, 2 * HW, assoc_window=win, window_merge="rows",
                      dense_model_rows=dense_rows)
    _assert_step_equal(mid_sequence, j, t)


def test_exact_path_model_rows_match_jax(mid_sequence):
    j, t = _step_both(mid_sequence, 2 * HW, dense_model_rows=True)
    _assert_step_equal(mid_sequence, j, t)


def test_model_rows_are_the_arena_at_the_model_image(mid_sequence):
    """The dense model rows equal a gather of the new arena at the model
    image (what the 'gather' option reads next frame)."""
    tstate = map_state_from_numpy(mid_sequence["data"], mid_sequence["num_points"], device="cpu")
    for kw in (dict(), dict(assoc_window=3 * HW), dict(assoc_window=3 * HW, window_merge="rows")):
        out, (_, _, img, rows) = TF.fusion_update_compact(
            tstate, *_args(mid_sequence, _t), 0.05, DOT_TH, 0.6, 2 * HW,
            return_active=True, dense_model_rows=True, **kw,
        )
        CAP = out.capacity
        g = torch.gather(out.data, 1, img.clamp(max=CAP - 1).long()[..., None].expand(-1, -1, 12))
        valid = img < CAP
        np.testing.assert_array_equal(rows[..., 6].numpy(), valid.numpy().astype(np.float32))
        np.testing.assert_array_equal(rows[..., :6][valid].numpy(), g[..., :6][valid].numpy())


@pytest.mark.parametrize("win_mult,active_mult", [(2, 2), (3, 2)], ids=["direct-window", "compacted"])
def test_dense_matches_rows_in_the_port(mid_sequence, win_mult, active_mult):
    """Twin of TestDenseWindowMergeEquivalence: two frames into an empty
    arena with each formulation; winners, appends, counts, the model image
    and the compacted set exact, merged floats to rtol 2e-5."""
    ms = mid_sequence
    K = _t(ms["K"])
    from gradslam_tpu_torch.slam.icpslam import _frame_maps

    res = {}
    for merge in ("rows", "dense"):
        m = init_map(2, 3 * HW, device="cpu")
        for f in (0, 1):
            vm, _, gv, gn, valid = _frame_maps(_t(ms["c"][:, f]), _t(ms["d"][:, f]), K, _t(ms["P"][:, f]))
            m, act = TF.fusion_update_compact(
                m, gv, gn, vm, _t(ms["c"][:, f]), valid, _t(ms["P"][:, f]), K, 0.05, DOT_TH, 0.6,
                active_mult * HW, assoc_window=win_mult * HW, window_merge=merge,
                return_active=True, dense_model_rows=True,
            )
        res[merge] = (m, act)
    (mr, ar), (md, ad) = res["rows"], res["dense"]
    np.testing.assert_array_equal(md.num_points.numpy(), mr.num_points.numpy())
    np.testing.assert_array_equal(md.ccounts.numpy(), mr.ccounts.numpy())
    for a, b in zip(ar[:3], ad[:3]):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_allclose(ad[3].numpy(), ar[3].numpy(), rtol=2e-5, atol=5e-5)
    np.testing.assert_allclose(md.data.numpy(), mr.data.numpy(), rtol=2e-5, atol=5e-5)


def test_resolve_helpers_match_jax():
    for mode in ("auto", "dense", "gather"):
        for cap in (10 * HW, 12 * HW, 16 * HW):
            assert TF._resolve_model_rows(mode, H, W, cap) == JF._resolve_model_rows(mode, H, W, cap)
    with pytest.raises(ValueError, match="model_rows"):
        TF._resolve_model_rows("bogus", H, W, HW)
    for aw in (None, -1, 0, 100, 3 * HW, 4 * HW, 5 * HW):
        assert TF._resolve_assoc_window(aw, 4 * HW) == JF._resolve_assoc_window(aw, 4 * HW)
