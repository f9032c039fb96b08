"""The port's checkpoint and profiling helpers (mirrors
tests/structures/test_checkpoint.py): the npz layout is the JAX package's,
so a checkpoint written by either package loads in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.structures import append_to_map as j_append_to_map
from gradslam_tpu.structures import init_map as j_init_map
from gradslam_tpu.utils import load_slam_state as j_load
from gradslam_tpu.utils import save_slam_state as j_save
from gradslam_tpu_torch.structures import append_to_map, init_map
from gradslam_tpu_torch.utils import DeviceTimer, annotate, load_slam_state, save_slam_state, sync, trace


def _map(rng):
    m = init_map(2, 20, device="cpu")
    pts = torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32))
    return append_to_map(m, pts, pts, pts, pts[..., :1], torch.ones(2, 5, dtype=torch.bool))


class TestCheckpoint:
    def test_npz_round_trip(self, tmp_path):
        rng = np.random.RandomState(0)
        m = _map(rng)
        poses = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
        save_slam_state(str(tmp_path / "state.npz"), m, poses)
        m2, poses2 = load_slam_state(str(tmp_path / "state.npz"), device="cpu")
        assert torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points)
        assert torch.equal(poses2, poses)
        save_slam_state(str(tmp_path / "bare"), m)  # numpy appends .npz
        m3, poses3 = load_slam_state(str(tmp_path / "bare.npz"), device="cpu")
        assert poses3 is None and m3.capacity == 20

    def test_the_packages_read_each_other(self, tmp_path):
        rng = np.random.RandomState(1)
        m = _map(rng)
        pose = torch.from_numpy(rng.randn(2, 4, 4).astype(np.float32))
        save_slam_state(str(tmp_path / "port.npz"), m, pose)
        jm, jpose = j_load(str(tmp_path / "port.npz"))
        assert np.array_equal(np.asarray(jm.data), m.data.numpy())
        assert np.array_equal(np.asarray(jm.num_points), m.num_points.numpy())
        assert np.array_equal(np.asarray(jpose), pose.numpy())

        jm = j_init_map(1, 8)
        pts = jnp.asarray(rng.randn(1, 3, 3).astype(np.float32))
        jm = j_append_to_map(jm, pts, pts, pts, jnp.ones((1, 3, 1)), jnp.ones((1, 3), bool))
        j_save(str(tmp_path / "jax.npz"), jm)
        tm, tpose = load_slam_state(str(tmp_path / "jax.npz"), device="cpu")
        assert tpose is None
        assert tm.data.dtype == torch.float32 and tm.num_points.dtype == torch.int32
        assert np.array_equal(tm.data.numpy(), np.asarray(jm.data))
        assert tm.num_points.tolist() == [3]

    def test_orbax_and_device_errors(self, tmp_path):
        """``use_orbax=True`` writes a torch.distributed.checkpoint directory
        that loads back bit for bit (tests/test_torch_checkpoint.py holds it
        across ranks); without a card a load that names no device raises."""
        rng = np.random.RandomState(2)
        m = _map(rng)
        poses = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
        save_slam_state(str(tmp_path / "o"), m, poses, use_orbax=True)
        assert (tmp_path / "o" / ".metadata").is_file()
        m2, poses2 = load_slam_state(str(tmp_path / "o"), use_orbax=True, device="cpu")
        assert torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points)
        assert torch.equal(poses2, poses)
        save_slam_state(str(tmp_path / "s.npz"), m)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load_slam_state(str(tmp_path / "s.npz"))


class TestProfiling:
    def test_timer_sync_and_annotate(self, capsys):
        m = _map(np.random.RandomState(3))
        with DeviceTimer("fusion", verbose=True) as t:
            with annotate("step"):
                out = (m, [m.data.sum()], {"x": torch.ones(2)})
            t.sync(out)
        sync(None)
        assert t.elapsed is not None and t.elapsed >= 0
        assert "[fusion]" in capsys.readouterr().out

    def test_trace_writes_a_trace(self, tmp_path):
        with trace(str(tmp_path)) as prof:
            with annotate("span"):
                torch.ones(8).sum()
        assert prof is not None
        assert list(tmp_path.glob("*.json")) or list(tmp_path.glob("*.json.gz"))
