"""Ranks of the port's distributed tests (tests/test_torch_parallel.py,
tests/test_torch_sharded.py, tests/test_torch_sharded_options.py and
tests/test_torch_checkpoint.py).

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


def launch(scenario: str, world: int, out: pathlib.Path, timeout: float = 100.0, cuda: bool = False) -> Ranks:
    """Starts ``world`` ranks of ``scenario`` writing into ``out``; the card
    is hidden from them unless ``cuda``."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
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
# mapping options beside the full-arena path, each alone, under make_mesh(data=2, map_=2)
MAP_AXIS_OPTIONS = {
    "projective_window": dict(assoc="projective", assoc_window=2 * 60 * 80),
    "window": dict(assoc_window=2 * 60 * 80),
    "aggregate": dict(fusion=False),
    "block_size": dict(block_size=1024),
    "no_reuse": dict(reuse_actives=False),
}
# 2.5 frames of the strided clip: map rank 1 holds live rows, and the 2-frame window spans both ranks
MAP_AXIS_CAPACITY = 5 * 60 * 80 // 2
TRAIN = dict(opts=dict(odom="gradicp", numiters=4, dsratio=2, fusion=True), scale=1.05, bias=0.01, lr=1e-3, steps=2)
# the gradient is ~1e-6: a step at this lr moves the parameters by ~1e-2, so
# float32 parameters show it to ~1e-5 of the move
TRAIN_MOVE_LR = 1e4
# tests/test_torch_sharded_options.py: JAX's flagship configuration
# (tests/parallel/test_sharded.py) on the clip tiled to B=4, windows that
# span three of four map ranks (the 'rows' and 'dense' merges), and gating
# whose blocks straddle the map ranks (7,200 rows a rank, blocks of 700)
FLAGSHIP = dict(SHARDED_OPTS, assoc="projective", assoc_window=2 * 60 * 80)
SPAN_FRAMES = (0, 1, 2, 1)
SPAN_CAPACITY = 2 * 60 * 80  # 2,400 rows a rank on four ranks
SPAN_WINDOW = 5 * 60 * 80 // 4  # slots [0, 6000): ranks 0, 1 and 2
GATED = dict(SHARDED_OPTS, block_size=700, visible_capacity=6)
PIPE_OPTS = dict(odom="gradicp", numiters=6, dsratio=4, fusion=True)  # tests/parallel/test_pipeline.py's
SEQPAR_OPTS = dict(odom="gradicp", numiters=10, dsratio=4, fusion=True)  # tests/parallel/test_seqpar.py's
SEQPAR_FRAMES = (0, 1, 2, 1, 0, 1, 2)


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _sharded4(rank, res):
    """sharded_slam over make_mesh(data=2, map_=2) with the full-arena
    options and each of MAP_AXIS_OPTIONS, sharded_train_step over it, and
    the port's single-process run of the same batch on rank 0."""
    import torch

    from gradslam_tpu_torch.parallel import (
        make_mesh,
        shard_map_state,
        sharded_slam,
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
    for name, kw in MAP_AXIS_OPTIONS.items():
        _run_sharded(mesh, rank, res, name, rgb, dep, K, SLAMOptions(**dict(SHARDED_OPTS, **kw)), MAP_AXIS_CAPACITY)
    _train_map(mesh, rank, res)


def _run_sharded(mesh, rank, res, key, rgb, dep, K, opts, cap):
    """``sharded_slam`` of ``opts``; rank 0 writes the assembled arena and
    poses and whether they are bit-equal to the port's single-process run."""
    import torch

    from gradslam_tpu_torch.parallel import sharded_slam, unshard_batch, unshard_map_state
    from gradslam_tpu_torch.slam import slam_sequence

    m, p = sharded_slam(mesh, rgb, dep, K, None, opts, cap)
    res[f"{key}_shard_shape"] = np.array(m.data.shape)
    g, pg = unshard_map_state(mesh, m), unshard_batch(mesh, p)
    if rank == 0:
        m1, p1 = slam_sequence(rgb, dep, K, None, opts, cap)
        res[f"{key}_data"], res[f"{key}_num_points"], res[f"{key}_poses"] = (
            g.data.numpy(), g.num_points.numpy(), pg.numpy())
        res[f"{key}_bitequal"] = np.array(
            torch.equal(g.data, m1.data) and torch.equal(g.num_points, m1.num_points) and torch.equal(pg, p1))


def _train_map(mesh, rank, res):
    """``sharded_train_step`` over the (data, map) mesh: TRAIN's steps, and
    one step at ``TRAIN_MOVE_LR`` from TRAIN's start."""
    from gradslam_tpu_torch.parallel import DepthCalibParams, sharded_train_step
    from gradslam_tpu_torch.slam import SLAMOptions

    rgb, dep, K, gt = (_t(x) for x in golden_clip(4))
    B, L, H, W, _ = rgb.shape
    opts = SLAMOptions(**TRAIN["opts"])
    step = sharded_train_step(mesh, opts, L * H * W, lr=TRAIN["lr"])
    params = DepthCalibParams(TRAIN["scale"], TRAIN["bias"], device="cpu")
    out = {"loss": [], "scale": [], "bias": []}
    for _ in range(TRAIN["steps"]):
        params, loss = step(params, rgb, dep, K, gt)
        out["loss"].append(float(loss))
        out["scale"].append(float(params.scale))
        out["bias"].append(float(params.bias))
    for k, v in out.items():
        res[f"train_map_{k}"] = np.array(v)
    step = sharded_train_step(mesh, opts, L * H * W, lr=TRAIN_MOVE_LR)
    moved, _ = step(DepthCalibParams(TRAIN["scale"], TRAIN["bias"], device="cpu"), rgb, dep, K, gt)
    res["train_map_move"] = np.array([float(moved.scale), float(moved.bias)])


def _options4(rank, res):
    """The map axis's options at their edges: JAX's flagship configuration
    over make_mesh(data=2, map_=2) on a B=4 batch, windows across three of
    four map ranks, gating with blocks across map ranks, and the owner-placed
    sum's gradient in a map group of two."""
    from gradslam_tpu_torch.parallel import make_mesh
    from gradslam_tpu_torch.slam import SLAMOptions

    mesh = make_mesh(data=2, map_=2, device="cpu")
    rgb, dep, K, _ = (_t(x) for x in golden_clip(2, reps=(0, 1, 0, 1)))
    B, L, H, W, _ = rgb.shape
    _run_sharded(mesh, rank, res, "flagship", rgb, dep, K, SLAMOptions(**FLAGSHIP), L * H * W)
    rgb2, dep2, K2 = rgb[:2], dep[:2], K[:2]
    _run_sharded(mesh, rank, res, "gated", rgb2, dep2, K2, SLAMOptions(**GATED), L * H * W)
    _owner_sum_grad(mesh, rank, res)
    _visible_rows(mesh, rank, res)
    mesh4 = make_mesh(data=1, map_=4, device="cpu")
    rgb4, dep4, K4, _ = (_t(x) for x in golden_clip(2, frames=SPAN_FRAMES))
    for merge in ("rows", "dense"):
        opts = SLAMOptions(**dict(SHARDED_OPTS, assoc_window=SPAN_WINDOW, window_merge=merge))
        _run_sharded(mesh4, rank, res, f"span_{merge}", rgb4, dep4, K4, opts, SPAN_CAPACITY)


# the block-gating unit: 2,000 rows on two map ranks, blocks of 300 (block 3
# straddles the ranks); the frame and its camera
VIS = dict(cap=2000, blk=300, H=48, W=64, f=50.0)


def visible_rows_arena():
    """(data (2, cap, 12), num_points (2,), pose (2, 4, 4), K (2, 1, 4, 4)):
    batch element 0 puts the rows of block 3 on map rank 0 100 m aside of
    the camera's view and those on rank 1 in it, so only the whole block's
    sphere is visible; element 1 is random points around the camera."""
    cap, blk, H, W, f = VIS["cap"], VIS["blk"], VIS["H"], VIS["W"], VIS["f"]
    rng = np.random.RandomState(5)
    data = np.zeros((2, cap, 12), np.float32)
    data[0, :, 0:3] = rng.uniform(-0.2, 0.2, (cap, 3)) + [0.0, 0.0, 2.0]
    data[0, 3 * blk : cap // 2, 0] += 100.0  # rank 0's part of block 3
    data[0, 6 * blk : 7 * blk, 2] = -3.0  # a block behind the camera
    data[0, 5 * blk : 6 * blk, 1] += 50.0  # a block out of view
    data[1, :, 0:3] = rng.uniform(-6, 6, (cap, 3))
    num_points = np.array([cap - 150, cap // 2 + 40], np.int32)
    pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K = np.tile(np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (2, 1, 1, 1))
    return data, num_points, pose, K


def _visible_rows(mesh, rank, res):
    """``fusionutils._visible_subarena_shard`` on each rank's shard of
    :func:`visible_rows_arena`, at visible capacities that keep every
    visible block and that cut them: the rank's gated rows as a mask of its
    local rows, the sub-arena's size, and whether its live rows are the
    arena's rows at their slots."""
    import torch

    from gradslam_tpu_torch.slam.fusionutils import _visible_subarena_shard
    from gradslam_tpu_torch.structures import MapState

    data, num_points, pose, K = (_t(x) for x in visible_rows_arena())
    shard = mesh.map_shard(VIS["cap"])
    local = MapState(data[:, shard.offset : shard.offset + shard.rows], num_points)
    res["visible_offset"] = np.array(shard.offset)
    for V in (7, 3):
        sub, slots, live = _visible_subarena_shard(local, pose, K, VIS["H"], VIS["W"], VIS["blk"], V, shard)
        mask = torch.zeros((2, shard.rows + 1), dtype=torch.bool)
        mask = mask.scatter(1, torch.where(live, slots - shard.offset, shard.rows).long(), True)[:, : shard.rows]
        rows_at = torch.gather(data, 1, torch.clamp(slots, max=VIS["cap"] - 1).long()[..., None].expand(-1, -1, 12))
        res[f"visible_rows_{V}"] = mask.numpy()
        res[f"visible_subrows_{V}"] = np.array(slots.shape[1])
        res[f"visible_data_{V}"] = np.array(bool((sub == rows_at)[live].all()))


def _owner_sum_grad(mesh, rank, res, B=2, cap=64, C=6, M=40):
    """The gradient through ``MapShard.gather_rows`` in a map group of two:
    a parameter ``theta`` scales the arena (a shard's computation) and enters
    the loss alone (a replicated one); each rank differentiates its loss
    divided by the group's size, as ``sharded_train_step`` does. Writes the
    rank's arena gradient and ``theta``'s gradient summed over the group,
    and rank 0 one process's."""
    import torch

    rng = np.random.RandomState(0)
    arena = rng.randn(B, cap, C).astype(np.float32)
    slots = rng.randint(0, cap, size=(B, M)).astype(np.int32)
    target = rng.randn(B, M, C).astype(np.float32)
    shard = mesh.map_shard(cap)

    def loss_of(local, theta, gather):
        rows = gather(local * theta, _t(slots))
        return ((rows - _t(target)) ** 2).sum() + theta**3

    local = _t(arena[:, shard.offset : shard.offset + shard.rows]).requires_grad_()
    theta = torch.tensor(1.5, requires_grad=True)
    g_local, g_theta = torch.autograd.grad(loss_of(local, theta, shard.gather_rows) / shard.n, [local, theta])
    res["ownersum_grad_local"] = g_local.numpy()
    res["ownersum_grad_theta"] = np.array(float(shard.all_reduce(g_theta.clone())))
    res["ownersum_offset"] = np.array(shard.offset)
    if rank == 0:
        whole = _t(arena).requires_grad_()
        theta1 = torch.tensor(1.5, requires_grad=True)
        take = lambda d, s: torch.gather(d, 1, s.long()[..., None].expand(-1, -1, C))
        r_local, r_theta = torch.autograd.grad(loss_of(whole, theta1, take), [whole, theta1])
        res["ownersum_ref_local"], res["ownersum_ref_theta"] = r_local.numpy(), np.array(float(r_theta))


def _flagship_cuda2(rank, res):
    """The flagship configuration over make_mesh(data=1, map_=2) on card 0."""
    import torch

    from gradslam_tpu_torch.parallel import make_mesh, sharded_slam, unshard_batch, unshard_map_state
    from gradslam_tpu_torch.slam import SLAMOptions

    torch.cuda.set_device(0)
    mesh = make_mesh(data=1, map_=2, device="cuda")
    rgb, dep, K, _ = (_t(x).cuda() for x in golden_clip(2))
    B, L, H, W, _ = rgb.shape
    m, p = sharded_slam(mesh, rgb, dep, K, None, SLAMOptions(**FLAGSHIP), L * H * W)
    res["num_points"] = unshard_map_state(mesh, m).num_points.cpu().numpy()
    res["poses"] = unshard_batch(mesh, p).cpu().numpy()


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


# the checkpointed run: the 4x-strided clip's frames in an arena of 2*H*W
# rows, whose live rows reach map rank 1 of 2 (and rank 2 of 4)
CKPT_FRAMES = (0, 1, 2)
CKPT_LOAD_MESHES = ((1, 4), (2, 2))  # (data, map) shapes that load a checkpoint saved at (1, 2)


def _ckpt2(rank, res, out):
    """sharded_slam over make_mesh(data=1, map_=2), its state saved by every
    rank as its own shard into ``<out>/ckpt`` (``use_orbax=True``), and
    the assembled state."""
    from gradslam_tpu_torch.parallel import make_mesh, sharded_slam, unshard_batch, unshard_map_state
    from gradslam_tpu_torch.slam import SLAMOptions
    from gradslam_tpu_torch.utils import save_slam_state

    mesh = make_mesh(data=1, map_=2, device="cpu")
    rgb, dep, K, _ = (_t(x) for x in golden_clip(4, frames=CKPT_FRAMES))
    H, W = rgb.shape[2:4]
    m, p = sharded_slam(mesh, rgb, dep, K, None, SLAMOptions(**SHARDED_OPTS), 2 * H * W)
    save_slam_state(str(out / "ckpt"), m, p, use_orbax=True, mesh=mesh)
    res["shard_shape"] = np.array(m.data.shape)
    g = unshard_map_state(mesh, m)
    res["data"], res["num_points"], res["poses"] = g.data.numpy(), g.num_points.numpy(), unshard_batch(mesh, p).numpy()


def _ckpt4(rank, res, out, inputs):
    """``<out>/ckpt`` loaded over each of CKPT_LOAD_MESHES, beside
    shard_map_state and shard_batch of the whole state in ``inputs``, and
    the error of a load over data=4."""
    from gradslam_tpu_torch.parallel import make_mesh, shard_batch, shard_map_state
    from gradslam_tpu_torch.structures import MapState
    from gradslam_tpu_torch.utils import load_slam_state

    whole = MapState(_t(inputs["data"]), _t(inputs["num_points"]))
    for data, map_ in CKPT_LOAD_MESHES:
        mesh = make_mesh(data=data, map_=map_, device="cpu")
        m, p = load_slam_state(str(out / "ckpt"), use_orbax=True, mesh=mesh)
        ref = shard_map_state(mesh, whole)
        key = f"{data}x{map_}"
        res[f"{key}_data"], res[f"{key}_num_points"], res[f"{key}_poses"] = m.data.numpy(), m.num_points.numpy(), p.numpy()
        res[f"{key}_ref_data"], res[f"{key}_ref_num_points"] = ref.data.numpy(), ref.num_points.numpy()
        res[f"{key}_ref_poses"] = shard_batch(mesh, _t(inputs["poses"])).numpy()
    try:  # the batch of 2 over four data groups
        load_slam_state(str(out / "ckpt"), use_orbax=True, mesh=make_mesh(data=4, map_=1, device="cpu"))
    except ValueError as e:
        res["indivisible"] = np.array(str(e))


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
    elif scenario == "options4":
        _options4(rank, res)
    elif scenario == "flagship_cuda2":
        _flagship_cuda2(rank, res)
    elif scenario == "pair2":
        _pair2(rank, res)
    elif scenario == "parallel2":
        with np.load(inputs) as z:
            _parallel2(rank, res, {k: z[k] for k in z.files})
    elif scenario == "ckpt2":
        _ckpt2(rank, res, out)
    elif scenario == "ckpt4":
        with np.load(inputs) as z:
            _ckpt4(rank, res, out, {k: z[k] for k in z.files})
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    torch.distributed.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1:])
