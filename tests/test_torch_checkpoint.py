"""The port's sharding-aware checkpoint (``use_orbax=True``: a
``torch.distributed.checkpoint`` directory), the counterpart of the JAX
package's orbax form (tests/structures/test_checkpoint.py).

Two gloo ranks on the CPU (``tests/torch_dist_worker.py`` scenario
``ckpt2``) run ``sharded_slam`` over ``make_mesh(data=1, map_=2)`` on the
golden clip strided 4x and save their shards; four ranks (``ckpt4``) load
the directory over data=1 x map=4 and data=2 x map=2. Every load is held bit
for bit: in one process against ``unshard_map_state`` of the saving ranks,
on each rank against ``shard_map_state`` of the whole. The npz form stays the
one that crosses between the packages.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.structures import append_to_map as j_append_to_map
from gradslam_tpu.structures import init_map as j_init_map
from gradslam_tpu.utils import save_slam_state as j_save
from gradslam_tpu_torch.utils import load_slam_state, save_slam_state
from tests.torch_dist_worker import CKPT_LOAD_MESHES, launch


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The ckpt2 ranks' results and their checkpoint directory."""
    out = tmp_path_factory.mktemp("ckpt2")
    return launch("ckpt2", 2, out).wait(), out / "ckpt"


@pytest.fixture(scope="module")
def loaded(tmp_path_factory, saved):
    """The ckpt4 ranks' shards of the ckpt2 checkpoint."""
    results, ckpt = saved
    out = tmp_path_factory.mktemp("ckpt4")
    shutil.copytree(ckpt, out / "ckpt")
    np.savez(out / "inputs.npz", **{k: results[0][k] for k in ("data", "num_points", "poses")})
    return launch("ckpt4", 4, out).wait()


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def test_each_rank_writes_its_own_shard(saved):
    results, ckpt = saved
    whole = results[0]["data"]
    assert [list(r["shard_shape"]) for r in results] == [[2, whole.shape[1] // 2, 12]] * 2
    # one file a rank, each with its half of the arena, none with the whole
    files = sorted(ckpt.glob("*.distcp"))
    assert len(files) == 2
    for f in files:
        assert 0.4 * whole.nbytes < f.stat().st_size < 0.6 * whole.nbytes, (f.name, f.stat().st_size, whole.nbytes)
    assert int(results[0]["num_points"].min()) > whole.shape[1] // 2, "no live row on map rank 1"


def test_one_process_loads_the_whole_state(saved):
    results, ckpt = saved
    m, poses = load_slam_state(str(ckpt), use_orbax=True, device="cpu")
    assert _equal(m.data.numpy(), results[0]["data"])
    assert _equal(m.num_points.numpy(), results[0]["num_points"])
    assert _equal(poses.numpy(), results[0]["poses"])
    for r in results[1:]:
        assert all(_equal(r[k], results[0][k]) for k in ("data", "num_points", "poses"))


@pytest.mark.parametrize("shape", CKPT_LOAD_MESHES, ids=lambda s: f"data{s[0]}xmap{s[1]}")
def test_ranks_load_their_shards(loaded, shape):
    key = "{}x{}".format(*shape)
    for r in loaded:
        for field in ("data", "num_points", "poses"):
            assert _equal(r[f"{key}_{field}"], r[f"{key}_ref_{field}"]), (key, field)


def test_a_mesh_that_does_not_divide_the_batch_is_refused(loaded):
    assert all("does not split over data=4 x map=1" in str(r["indivisible"]) for r in loaded)


def test_round_trip_in_one_process(tmp_path):
    """A save without a mesh loads back bit for bit; poses are optional."""
    rng = np.random.RandomState(0)
    from gradslam_tpu_torch.structures import MapState

    m = MapState(torch.from_numpy(rng.randn(3, 10, 12).astype(np.float32)), torch.tensor([1, 5, 9], dtype=torch.int32))
    save_slam_state(str(tmp_path / "a"), m, use_orbax=True)
    m2, poses = load_slam_state(str(tmp_path / "a"), use_orbax=True, device="cpu")
    assert poses is None and torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points)


def test_a_jax_npz_still_loads_and_saves_as_a_directory(tmp_path):
    """The npz form crosses between the packages; what the port loads from
    it round-trips through the directory form unchanged."""
    rng = np.random.RandomState(1)
    jm = j_init_map(2, 16)
    pts = jnp.asarray(rng.randn(2, 5, 3).astype(np.float32))
    jm = j_append_to_map(jm, pts, pts, pts, jnp.ones((2, 5, 1)), jnp.ones((2, 5), bool))
    pose = rng.randn(2, 4, 4).astype(np.float32)
    j_save(str(tmp_path / "jax.npz"), jm, jnp.asarray(pose))
    m, p = load_slam_state(str(tmp_path / "jax.npz"), device="cpu")
    assert np.array_equal(m.data.numpy(), np.asarray(jm.data)) and np.array_equal(p.numpy(), pose)
    save_slam_state(str(tmp_path / "dcp"), m, p, use_orbax=True)
    m2, p2 = load_slam_state(str(tmp_path / "dcp"), use_orbax=True, device="cpu")
    assert torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points) and torch.equal(p2, p)
