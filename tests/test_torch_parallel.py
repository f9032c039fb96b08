"""The port's multihost, mesh, sequence-parallel and sharded-refinement
modules against the JAX package's (mirrors tests/parallel/test_multihost.py,
test_seqpar.py and the sharded classes of test_pose_refine.py).

The port's ranks are two gloo processes on the CPU
(``tests/torch_dist_worker.py``, scenario ``parallel2``): they meet through
``initialize_multihost``, build ``make_mesh(data=2)`` and run the sharded
pose graph and BA ('dense' and 'pcg') and ``sequence_parallel_slam`` over
the mesh. The JAX side runs here on the virtual CPU devices of
``tests/conftest.py``. Tolerances: the partition and ``chunk_sequence``
exact; the sharded refiners within 1e-4 of JAX's sharded ones; the
sequence-parallel poses within 1e-5 of JAX's in one process and 1e-4 over a
mesh, the JAX tests' own; the merged maps' points within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.parallel.test_pose_refine as J
from gradslam_tpu.parallel import make_mesh as j_make_mesh
from gradslam_tpu.parallel import pose_refine as JP
from gradslam_tpu.parallel import seqpar as JS
from gradslam_tpu.slam.icpslam import SLAMOptions as JOpts
from gradslam_tpu_torch import parallel as P
from gradslam_tpu_torch.slam import SLAMOptions
from tests.torch_dist_worker import SEQPAR_FRAMES, SEQPAR_OPTS, golden_clip, launch

torch.set_num_threads(2)


def _ragged_ba():
    """tests/parallel/test_pose_refine.py's ragged problem: some shard padded."""
    rng = np.random.RandomState(3)
    gt_p, gt_l, ip, il, op, ol, opts = J.make_ba_problem(rng, L=6, M=48, obs_per_lm=5)
    keep = rng.rand(len(ol)) > 0.4
    keep[np.searchsorted(ol, np.arange(48))] = True
    return ip, il, op[keep], ol[keep], opts[keep]


def _problems():
    graph, _ = J.make_graph(np.random.RandomState(3), L=10, noise=0.05, loop_closures=3)
    _, _, *ba = J.make_ba_problem(np.random.RandomState(7), L=6, M=64, obs_per_lm=4)
    out = {f"graph_{k}": np.asarray(v) for k, v in graph._asdict().items()}
    for name, arrays in (("ba", ba), ("ba_ragged", _ragged_ba())):
        out.update({f"{name}_{k}": np.asarray(v) for k, v in
                    zip(("poses", "landmarks", "obs_pose", "obs_lm", "obs_pts"), arrays)})
    return out


@pytest.fixture(scope="module")
def parallel2(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel2")
    problems = _problems()
    np.savez(out / "inputs.npz", **problems)
    ranks = launch("parallel2", 2, out)
    ranks.problems = problems
    return ranks


def test_single_process_multihost_and_mesh():
    """Nothing to join: a no-op; one rank, a 1x1 mesh, the identity shards."""
    P.initialize_multihost()
    assert not torch.distributed.is_initialized() and not P.is_multihost()
    assert P.host_summary() == "process 0/1, 1 local / 1 global devices (none)"
    with pytest.raises(ValueError, match="coordinator_address"):
        P.initialize_multihost(num_processes=2, backend="gloo")
    mesh = P.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "map": 1} and mesh.axis_names == ("data", "map")
    with pytest.raises(ValueError, match="world size 1"):
        P.make_mesh(data=2, device="cpu")
    x = torch.arange(12.0).reshape(2, 6)
    assert P.shard_batch(mesh, (x, None))[0].equal(x)
    from gradslam_tpu_torch.structures import init_map

    m = init_map(2, 8, device="cpu")
    assert P.shard_map_state(mesh, m).data.shape == (2, 8, 12)
    assert P.unshard_map_state(mesh, m).data.equal(m.data)


def test_two_rank_rendezvous(parallel2):
    for r, got in enumerate(parallel2.wait()):
        assert str(got["summary"]) == f"process {r}/2, 1 local / 2 global devices (gloo)"
        assert bool(got["multihost"]) and tuple(got["coords"]) == (r, 0)


def test_chunk_sequence_equals_jax():
    for n, Lc, L in ((3, 4, 10), (3, 3, 5), (4, 3, 7), (1, 7, 7)):
        x = np.random.default_rng(L).normal(size=(2, L, 3)).astype(np.float32)
        want = np.asarray(JS.chunk_sequence(jnp.asarray(x), n_chunks=n, chunk_len=Lc))
        np.testing.assert_array_equal(P.chunk_sequence(torch.from_numpy(x), n, Lc).numpy(), want)


def test_partition_equals_jax():
    rng = np.random.RandomState(3)
    N = 257
    ol = rng.randint(0, 40, N).astype(np.int32)
    op = rng.randint(0, 5, N).astype(np.int32)
    pts = rng.randn(N, 3).astype(np.float32)
    w = np.ones(N, np.float32)
    _, _, rop, rol, rpts = _ragged_ba()
    for args in ((op, ol, pts, w), (rop, rol, rpts, np.ones(len(rol), np.float32))):
        for n in (2, 3, 4, 8):
            got = P.partition_observations_by_landmark(*args, n)
            want = JP.partition_observations_by_landmark(*args, n)
            for g, v in zip(got[:4], want[:4]):
                assert g.dtype == v.dtype
                np.testing.assert_array_equal(g, v)
            assert got[4] == want[4]


def test_pose_graph_refine_sharded_matches_jax(parallel2):
    pr = parallel2.problems
    graph = JP.PoseGraph(*(jnp.asarray(pr[f"graph_{k}"]) for k in ("poses", "edges", "measurements", "weights")))
    want = np.asarray(JP.pose_graph_refine_sharded(graph, j_make_mesh(data=len(jax.devices())), num_iters=8))
    for got in parallel2.wait():
        np.testing.assert_allclose(got["pose_graph"], want, atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("prob", ["ba", "ba_ragged"])
def test_ba_refine_sharded_matches_jax(parallel2, prob, solver):
    pr = parallel2.problems
    args = [jnp.asarray(pr[f"{prob}_{k}"]) for k in ("poses", "landmarks", "obs_pose", "obs_lm", "obs_pts")]
    wp, wl = JP.ba_refine_sharded(*args, j_make_mesh(data=len(jax.devices())), num_iters=6, damping=1e-6,
                                  solver=solver)
    res = parallel2.wait()
    for got in res:
        np.testing.assert_allclose(got[f"{prob}_{solver}_poses"], np.asarray(wp), atol=1e-4)
        np.testing.assert_allclose(got[f"{prob}_{solver}_landmarks"], np.asarray(wl), atol=1e-4)
        np.testing.assert_array_equal(got[f"{prob}_{solver}_poses"], res[0][f"{prob}_{solver}_poses"])


def _seq(backend):
    colors, depths, K, _ = golden_clip(2, reps=(0,), frames=SEQPAR_FRAMES)
    if backend == "jax":
        return jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K), JOpts(**SEQPAR_OPTS)
    return torch.from_numpy(colors), torch.from_numpy(depths), torch.from_numpy(K), SLAMOptions(**SEQPAR_OPTS)


def test_sequence_parallel_over_mesh_matches_jax(parallel2):
    j = JS.sequence_parallel_slam(*_seq("jax"), n_chunks=4, mesh=j_make_mesh(data=4, map_=1, devices=jax.devices()[:4]))
    res = parallel2.wait()
    for got in res:
        np.testing.assert_allclose(got["seqpar_poses"], np.asarray(j.poses), atol=1e-4)
        np.testing.assert_allclose(got["seqpar_origins"], np.asarray(j.chunk_origins), atol=1e-4)
        np.testing.assert_array_equal(got["seqpar_chunk_num_points"], np.asarray(j.chunk_maps.num_points))
        np.testing.assert_allclose(got["seqpar_chunk_data"], np.asarray(j.chunk_maps.data), atol=1e-4)
        np.testing.assert_array_equal(got["seqpar_poses"], res[0]["seqpar_poses"])


def test_sequence_parallel_and_merge_match_jax():
    """One process: the stitched, refined and merged results of n_chunks=2
    against JAX's; the merge with a power-of-two voxel (XLA multiplies by a
    constant's reciprocal where the port divides) and with the JAX test's
    0.05 m one."""
    jargs, targs = _seq("jax"), _seq("torch")
    j = JS.sequence_parallel_slam(*jargs, n_chunks=2)
    t = P.sequence_parallel_slam(*targs, n_chunks=2)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), atol=1e-5)
    np.testing.assert_allclose(t.poses[:, 0].numpy(), np.eye(4)[None], atol=1e-6)
    jr = JS.sequence_parallel_slam(*jargs, n_chunks=2, refine=True, refine_iters=3)
    tr = P.sequence_parallel_slam(*targs, n_chunks=2, refine=True, refine_iters=3)
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses), atol=1e-5)
    for voxel in (None, 2.0**-5):
        jm, tm = JS.merge_chunk_maps(j, 1, dedup_voxel=voxel), P.merge_chunk_maps(t, 1, dedup_voxel=voxel)
        n = int(np.asarray(jm.num_points_per_pointcloud)[0])
        assert int(tm.num_points_per_pointcloud[0]) == n > (1000 if voxel is None else 0)
        for attr in ("points_padded", "normals_padded", "colors_padded", "features_padded"):
            np.testing.assert_allclose(getattr(tm, attr)[0, :n].numpy(), np.asarray(getattr(jm, attr))[0, :n],
                                       atol=1e-4, rtol=1e-5)
    raw, dd = P.merge_chunk_maps(t, 1), P.merge_chunk_maps(t, 1, dedup_voxel=0.05)
    n_raw, n_dd = int(raw.num_points_per_pointcloud[0]), int(dd.num_points_per_pointcloud[0])
    assert 0 < n_dd < n_raw
    np.testing.assert_allclose(dd.features_padded[0, :n_dd].sum().item(), raw.features_padded[0, :n_raw].sum().item(),
                               rtol=1e-4)
    with pytest.raises(ValueError):
        P.sequence_parallel_slam(*targs[:3], SLAMOptions(odom="gt"), n_chunks=2)


def test_sharded_refiners_on_one_rank():
    """A 1x1 mesh: the sharded refiners are the single-device ones bit for
    bit; an input that needs a gradient raises (no gradient crosses ranks)."""
    graph, _ = J.make_graph(np.random.RandomState(3), L=10, noise=0.05, loop_closures=3)
    g = P.PoseGraph(*(torch.from_numpy(np.array(x)) for x in graph))
    mesh = P.make_mesh(device="cpu")
    assert torch.equal(P.pose_graph_refine_sharded(g, mesh, num_iters=4), P.pose_graph_refine(g, num_iters=4))
    _, _, *ba = J.make_ba_problem(np.random.RandomState(7), L=6, M=64, obs_per_lm=4)
    args = [torch.from_numpy(np.array(x)) for x in ba]
    for solver in ("dense", "pcg"):
        got = P.ba_refine_sharded(*args, mesh, num_iters=3, solver=solver)
        want = P.ba_refine(*args, num_iters=3, solver=solver)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="no gradient"):
        P.pose_graph_refine_sharded(g._replace(poses=g.poses.clone().requires_grad_(True)), mesh)
