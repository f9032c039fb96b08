"""The map axis at its edges against the JAX package and the port's single
process (mirrors the flagship case of tests/parallel/test_sharded.py).

Four gloo ranks on the CPU (``tests/torch_dist_worker.py``, scenario
``options4``) run ``sharded_slam`` on the golden clip ``tests/data/msrd_b2s3``
strided 2x:

  - JAX's flagship configuration (projective association with
    ``assoc_window = 2*H*W``) over ``make_mesh(data=2, map_=2)`` on the clip
    tiled to B=4, as the JAX test tiles it to B=8, in the JAX test's arena of
    L*H*W rows: the window covers map rank 1's slots, which stay dead;
  - a window of 6,000 rows over four map ranks of 2,400, so slots of ranks
    0, 1 and 2 are in it, with the 'rows' and the 'dense' merge;
  - block gating with blocks of 700 rows on ranks of 7,200 (blocks straddle
    the ranks) and a visible capacity of 6 blocks, below the live blocks;
  - the gradient through ``MapShard.gather_rows`` in a map group of two;
  - the gated rows a rank gathers from an arena whose straddling block is
    visible only as a whole, against one process's ``visible_subarena``.

Each run is bit-equal to the port's single-process run, and within 1e-4 of
JAX's single-process ``slam_sequence`` (arena and poses) with ``num_points``
equal. The gradient: each rank's arena rows and the group's sum of the
parameter's gradient within 1e-6 relative of one process's. The gated rows:
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam.icpslam import SLAMOptions as JOpts
from gradslam_tpu.slam.icpslam import slam_sequence as j_slam_sequence
from gradslam_tpu_torch.slam.fusionutils import visible_subarena
from gradslam_tpu_torch.structures import MapState
from tests.torch_dist_worker import (
    FLAGSHIP,
    VIS,
    GATED,
    SHARDED_OPTS,
    SPAN_CAPACITY,
    SPAN_FRAMES,
    SPAN_WINDOW,
    golden_clip,
    launch,
    visible_rows_arena,
)


@pytest.fixture(scope="module")
def options4(tmp_path_factory):
    return launch("options4", 4, tmp_path_factory.mktemp("options4"))


def _case(key):
    """(clip, options, capacity, map ranks) of each run."""
    if key == "flagship":
        clip = golden_clip(2, reps=(0, 1, 0, 1))
        return clip, FLAGSHIP, int(np.prod(clip[0].shape[1:4])), 2
    if key == "gated":
        clip = golden_clip(2)
        return clip, GATED, int(np.prod(clip[0].shape[1:4])), 2
    merge = key.split("_")[1]
    opts = dict(SHARDED_OPTS, assoc_window=SPAN_WINDOW, window_merge=merge)
    return golden_clip(2, frames=SPAN_FRAMES), opts, SPAN_CAPACITY, 4


@pytest.mark.parametrize("key", ["flagship", "gated", "span_rows", "span_dense"])
def test_map_axis_edges_match_jax(options4, key):
    (colors, depths, K, _), opts, cap, n_map = _case(key)
    m, p = j_slam_sequence(jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), None, JOpts(**opts), cap)
    B = colors.shape[0]
    res = options4.wait()
    for got in res:
        assert tuple(got[f"{key}_shard_shape"]) == (B * n_map // 4, cap // n_map, 12)
    r0 = res[0]
    assert bool(r0[f"{key}_bitequal"]), f"{key}: not bit-equal to the port's single-process run"
    np.testing.assert_array_equal(r0[f"{key}_num_points"], np.asarray(m.num_points))
    np.testing.assert_allclose(r0[f"{key}_poses"], np.asarray(p), atol=1e-4)
    np.testing.assert_allclose(r0[f"{key}_data"], np.asarray(m.data), atol=1e-4)
    npts = r0[f"{key}_num_points"]
    if key.startswith("span"):  # live rows on the window's third rank
        assert (npts > 2 * cap // 4).all(), npts
    elif key == "gated":  # blocks of live rows on both map ranks
        assert (npts > cap // 2).any(), npts
    # the flagship's live rows stay on map rank 0 (the JAX test's capacity,
    # L*H*W); its window reaches rank 1's dead slots


def test_owner_sum_gradient_matches_one_process(options4):
    res = options4.wait()
    ref_local, ref_theta = res[0]["ownersum_ref_local"], float(res[0]["ownersum_ref_theta"])
    for got in res:
        off = int(got["ownersum_offset"])
        rows = got["ownersum_grad_local"].shape[1]
        np.testing.assert_allclose(got["ownersum_grad_local"], ref_local[:, off : off + rows], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(got["ownersum_grad_theta"]), ref_theta, rtol=1e-6)
    # both ranks of a group hold part of the gradient
    assert all(np.abs(got["ownersum_grad_local"]).sum() > 0 for got in res)


@pytest.mark.parametrize("V", [7, 3])
def test_visible_rows_match_one_process(options4, V):
    """Each rank's gated rows are its part of one process's: the straddling
    block 3 is assembled before its sphere is tested."""
    data, num_points, pose, K = (torch.from_numpy(x) for x in visible_rows_arena())
    sub, slots, live = visible_subarena(MapState(data, num_points), pose, K, VIS["H"], VIS["W"], VIS["blk"], V)
    want = torch.zeros((2, VIS["cap"] + 1), dtype=torch.bool)
    want = want.scatter(1, torch.where(live, slots, VIS["cap"]).long(), True)[:, : VIS["cap"]].numpy()
    if V == 7:  # block 3 is visible as a whole, the blocks behind and aside are not all
        assert want[0, 3 * VIS["blk"] : VIS["cap"] // 2].all()
    for got in options4.wait():
        off = int(got["visible_offset"])
        rows = got[f"visible_rows_{V}"]
        np.testing.assert_array_equal(rows, want[:, off : off + rows.shape[1]])
        # a rank gathers only the visible blocks it holds rows of, and their rows
        assert int(got[f"visible_subrows_{V}"]) <= V * VIS["blk"]
        assert bool(got[f"visible_data_{V}"])
