"""Ranks of the port's distributed tests (tests/test_torch_parallel.py and
tests/test_torch_sharded.py).

    python -m tests.torch_dist_worker <scenario> <rank> <world> <port> <dir>

Each rank joins a gloo process group on the CPU through the port's
``initialize_multihost``, runs its scenario's functions of
``gradslam_tpu_torch.parallel`` and writes what it got to
``<dir>/rank<rank>.npz``. It imports no JAX: the tests hold these results
against the JAX package's in their own process. ``<dir>/inputs.npz``, when
the test wrote one, holds the problems to solve.

:func:`launch` starts the ranks of a scenario; :meth:`Ranks.wait` collects
their results, failing the test on a rank's error or timeout.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data" / "msrd_b2s3"


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """The running ranks of one scenario."""

    def __init__(self, procs, out: pathlib.Path, timeout: float):
        self.procs, self.out, self.deadline = procs, out, time.monotonic() + timeout
        self._results = None

    def wait(self):
        """Each rank's results (a dict of arrays, rank order). A rank's
        nonzero exit stops the others at once; so does the timeout."""
        if self._results is None:
            procs = self.procs
            while any(p.poll() is None for p in procs) and time.monotonic() < self.deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for r, p in enumerate(procs):
                log = (self.out / f"rank{r}.log").read_text()
                assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{log}"
            self._results = []
            for r in range(len(procs)):
                with np.load(self.out / f"rank{r}.npz") as z:
                    self._results.append({k: z[k] for k in z.files})
        return self._results


def launch(scenario: str, world: int, out: pathlib.Path, timeout: float = 100.0) -> Ranks:
    """Starts ``world`` ranks of ``scenario`` writing into ``out``."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for r in range(world):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_worker", scenario, str(r), str(world), str(port), str(out)],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env,
            ))
    return Ranks(procs, out, timeout)


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def golden_clip(stride=2, reps=(0, 1), frames=None):
    """The golden clip's batch elements ``reps``, frames ``frames``, every
    ``stride``-th pixel, intrinsics scaled to it."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    reps = list(reps)
    fr = list(range(colors.shape[1])) if frames is None else list(frames)
    K[:, :, :2] /= stride
    pick = lambda x: x[reps][:, fr]
    return (pick(colors)[:, :, ::stride, ::stride], pick(depths)[:, :, ::stride, ::stride], K[reps],
            pick(poses))


SHARDED_OPTS = dict(odom="gradicp", numiters=5, fusion=True)  # tests/parallel/test_sharded.py's OPTS
# every mapping option that the map-sharded arena does not run yet, each alone
MAP_AXIS_REFUSED = {
    "projective_window": dict(assoc="projective", assoc_window=2 * 60 * 80),
    "window": dict(assoc_window=2 * 60 * 80),
    "aggregate": dict(fusion=False),
    "block_size": dict(block_size=1024),
    "no_reuse": dict(reuse_actives=False),
}
TRAIN = dict(opts=dict(odom="gradicp", numiters=4, dsratio=2, fusion=True), scale=1.05, bias=0.01, lr=1e-3, steps=2)
PIPE_OPTS = dict(odom="gradicp", numiters=6, dsratio=4, fusion=True)  # tests/parallel/test_pipeline.py's
SEQPAR_OPTS = dict(odom="gradicp", numiters=10, dsratio=4, fusion=True)  # tests/parallel/test_seqpar.py's
SEQPAR_FRAMES = (0, 1, 2, 1, 0, 1, 2)


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _sharded4(rank, res):
    """sharded_slam over make_mesh(data=2, map_=2), its refusals, and the
    port's single-process run of the same batch on rank 0."""
    import torch

    from gradslam_tpu_torch.parallel import (
        make_mesh,
        shard_map_state,
        sharded_slam,
        sharded_train_step,
        unshard_batch,
        unshard_map_state,
    )
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence

    mesh = make_mesh(data=2, map_=2, device="cpu")
    res["coords"] = np.array([mesh.index("data"), mesh.index("map")])
    rgb, dep, K, _ = (_t(x) for x in golden_clip(2))
    B, L, H, W, _ = rgb.shape
    cap = L * H * W
    opts = SLAMOptions(**SHARDED_OPTS)
    m, p = sharded_slam(mesh, rgb, dep, K, None, opts, cap)
    res["shard_shape"] = np.array(m.data.shape)
    res["shard_num_points"] = m.num_points.numpy()
    g = unshard_map_state(mesh, m)
    res["data"], res["num_points"] = g.data.numpy(), g.num_points.numpy()
    res["poses"] = unshard_batch(mesh, p).numpy()
    back = shard_map_state(mesh, g)
    res["roundtrip"] = np.array(torch.equal(back.data, m.data) and torch.equal(back.num_points, m.num_points))
    if rank == 0:
        m1, p1 = slam_sequence(rgb, dep, K, None, opts, cap)
        res["ref_data"], res["ref_num_points"], res["ref_poses"] = m1.data.numpy(), m1.num_points.numpy(), p1.numpy()
    # four map shards of 4,800 rows: every fusion step after the first
    # selects among the rows of several shards
    mesh4 = make_mesh(data=1, map_=4, device="cpu")
    rgb4, dep4, K4, _ = (_t(x) for x in golden_clip(2, frames=(0, 1, 2, 1)))
    cap4 = 4 * H * W
    m4, p4 = sharded_slam(mesh4, rgb4, dep4, K4, None, opts, cap4)
    res["map4_shard_shape"] = np.array(m4.data.shape)
    g4 = unshard_map_state(mesh4, m4)
    if rank == 0:
        m1, p1 = slam_sequence(rgb4, dep4, K4, None, opts, cap4)
        res["map4_num_points"], res["map4_ref_num_points"] = g4.num_points.numpy(), m1.num_points.numpy()
        res["map4_bitequal"] = np.array(torch.equal(g4.data, m1.data) and torch.equal(p4, p1))
    for name, kw in MAP_AXIS_REFUSED.items():
        try:
            sharded_slam(mesh, rgb, dep, K, None, SLAMOptions(**dict(SHARDED_OPTS, **kw)), cap)
            res[f"refused_{name}"] = np.array("")
        except ValueError as e:
            res[f"refused_{name}"] = np.array(str(e))
    try:
        sharded_train_step(mesh, opts, cap)
        res["refused_train"] = np.array("")
    except ValueError as e:
        res["refused_train"] = np.array(str(e))


def _pair2(rank, res):
    """sharded_train_step over make_mesh(data=2) and pipelined_slam_sequence
    on the pair, with the port's single-process pipeline oracle on rank 1."""
    import torch

    from gradslam_tpu_torch.parallel import DepthCalibParams, make_mesh, pipeline_mesh, pipelined_slam_sequence
    from gradslam_tpu_torch.parallel import sharded_train_step
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence

    mesh = make_mesh(data=2, device="cpu")
    rgb, dep, K, gt = (_t(x) for x in golden_clip(4))
    B, L, H, W, _ = rgb.shape
    step = sharded_train_step(mesh, SLAMOptions(**TRAIN["opts"]), L * H * W, lr=TRAIN["lr"])
    params = DepthCalibParams(TRAIN["scale"], TRAIN["bias"], device="cpu")
    losses, scales, biases = [], [], []
    for _ in range(TRAIN["steps"]):
        params, loss = step(params, rgb, dep, K, gt)
        losses.append(float(loss))
        scales.append(float(params.scale))
        biases.append(float(params.bias))
    res["train_loss"], res["train_scale"], res["train_bias"] = np.array(losses), np.array(scales), np.array(biases)

    pm = pipeline_mesh(device="cpu")
    rgb, dep, K, _ = (_t(x) for x in golden_clip(2, frames=(0, 1, 2, 1)))
    B, L, H, W, _ = rgb.shape
    for assoc in ("knn", "projective"):
        opts = SLAMOptions(**dict(PIPE_OPTS, assoc=assoc))
        m, p = pipelined_slam_sequence(rgb, dep, K, opts, L * H * W, mesh=pm)
        res[f"pipe_{assoc}_data"], res[f"pipe_{assoc}_num_points"] = m.data.numpy(), m.num_points.numpy()
        res[f"pipe_{assoc}_poses"] = p.numpy()
        if rank == 1:
            m1, p1 = slam_sequence(rgb, dep, K, None, opts, L * H * W)
            res[f"pipe_{assoc}_bitequal"] = np.array(
                torch.equal(m1.data, m.data) and torch.equal(m1.num_points, m.num_points) and torch.equal(p1, p)
            )


def _parallel2(rank, res, inputs):
    """The sharded pose graph and BA, and sequence_parallel_slam over
    make_mesh(data=2)."""
    from gradslam_tpu_torch.parallel import (
        PoseGraph,
        ba_refine_sharded,
        make_mesh,
        pose_graph_refine_sharded,
        sequence_parallel_slam,
    )
    from gradslam_tpu_torch.slam import SLAMOptions

    mesh = make_mesh(data=2, device="cpu")
    res["coords"] = np.array([mesh.index("data"), mesh.index("map")])
    graph = PoseGraph(*(_t(inputs[f"graph_{k}"]) for k in ("poses", "edges", "measurements", "weights")))
    res["pose_graph"] = pose_graph_refine_sharded(graph, mesh, num_iters=8).numpy()
    for prob in ("ba", "ba_ragged"):
        args = [_t(inputs[f"{prob}_{k}"]) for k in ("poses", "landmarks", "obs_pose", "obs_lm", "obs_pts")]
        for solver in ("dense", "pcg"):
            p, lm = ba_refine_sharded(*args, mesh, num_iters=6, damping=1e-6, solver=solver)
            res[f"{prob}_{solver}_poses"], res[f"{prob}_{solver}_landmarks"] = p.numpy(), lm.numpy()
    rgb, dep, K, _ = (_t(x) for x in golden_clip(2, reps=(0,), frames=SEQPAR_FRAMES))
    r = sequence_parallel_slam(rgb, dep, K, SLAMOptions(**SEQPAR_OPTS), n_chunks=4, mesh=mesh)
    res["seqpar_poses"], res["seqpar_origins"] = r.poses.numpy(), r.chunk_origins.numpy()
    res["seqpar_chunk_data"], res["seqpar_chunk_num_points"] = r.chunk_maps.data.numpy(), r.chunk_maps.num_points.numpy()


def main(argv) -> None:
    scenario, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3], pathlib.Path(argv[4])
    import torch

    torch.set_num_threads(1)
    from gradslam_tpu_torch.parallel import host_summary, initialize_multihost, is_multihost

    initialize_multihost(f"localhost:{port}", num_processes=world, process_id=rank, backend="gloo")
    res = {"summary": np.array(host_summary()), "multihost": np.array(is_multihost())}
    inputs = out / "inputs.npz"
    if scenario == "sharded4":
        _sharded4(rank, res)
    elif scenario == "pair2":
        _pair2(rank, res)
    elif scenario == "parallel2":
        with np.load(inputs) as z:
            _parallel2(rank, res, {k: z[k] for k in z.files})
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    torch.distributed.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1:])
