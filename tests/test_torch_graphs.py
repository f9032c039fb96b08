"""The captured frame step (``gradslam_tpu_torch/slam/stepgraph.py``) on the CPU.

A CUDA graph exists only on the card; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 32 capture and replay it there. Here:

- every option set the graph serves runs ``slam_init_state``,
  ``slam_step_state`` and the graph's own step function on the ``meta``
  device, whose tensors raise on ``.item()``, ``int()``, ``nonzero`` and
  boolean indexing: the step has no host read and no data-dependent shape;
- the static-buffer step (the function the graph captures, run without a
  graph) is bit-equal to ``slam_sequence``'s eager loop over the golden
  clip, in every field of the carried state, and within
  ``tests/test_torch_parity.py``'s gradICP tolerances of JAX's
  ``slam_sequence`` (poses 2e-3, ``num_points`` 5%, map distances 2e-4 m
  median and 1e-2 m 99th percentile);
- a CPU model of the winner kernel's table schedule under replay: every
  replay folds into a clean table;
- the dispatch rules: ``disable_graphs()``, a gradient, a map shard, and
  ``slam_sequence``, the managed run, ``ICPSLAM.step_state`` and
  ``ICPSLAM.step`` routed through the graph's function (the device rule
  lifted), each bit-equal to its eager run;
- the caches keep the graphs used last and no more.

Where the card captures and replays, these tests run the graph's function
itself (the ``uncaptured`` fixture).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch import PointFusion, RGBDImages, clear_graphs, disable_graphs, init_map
from gradslam_tpu_torch.ops.winner import _WinnerKernel
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.slam import lifecycle, stepgraph
from gradslam_tpu_torch.slam.mapshard import MapShard

torch.set_num_threads(2)

DATA = __import__("pathlib").Path(__file__).parent / "data" / "msrd_b2s3"
H, W = 120, 160


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics", "poses")}


def _cycled(clip, L, step=1):
    """The clip cycled to L frames, every ``step``-th pixel (intrinsics
    scaled with it), as torch tensors: (rgb, depth, K, poses)."""
    idx = [i % clip["colors"].shape[1] for i in range(L)]
    K = clip["intrinsics"].copy()
    K[:, :, :2] /= step
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        clip["colors"][:, idx, ::step, ::step], clip["depths"][:, idx, ::step, ::step], K, clip["poses"][:, idx]))


@pytest.fixture
def uncaptured(monkeypatch):
    """Runs a graph's function where the card would capture and replay it."""
    monkeypatch.setattr(stepgraph._Captured, "__call__", lambda self, fn: fn())


def _fields(state):
    return [t for t in stepgraph.state_tensors(state) if t is not None]


def _assert_states_equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and torch.equal(x, y)


# ---------------------------------------------------------------------------
# capturability: the step on the meta device
# ---------------------------------------------------------------------------

MB, MH, MW = 2, 16, 16
MHW = MH * MW
META_OPTIONS = {
    "exact knn": dict(fusion=True),
    "projective window gather": dict(fusion=True, assoc="projective", assoc_window=2 * MHW, model_rows="gather"),
    "projective window dense": dict(fusion=True, assoc="projective", assoc_window=2 * MHW, model_rows="dense"),
    "rows window": dict(fusion=True, assoc_window=2 * MHW, window_merge="rows"),
    "dense window": dict(fusion=True, assoc_window=2 * MHW, window_merge="dense"),
    "block gating": dict(fusion=True, block_size=256),
    "labels": dict(fusion=True),
    "gt odometry": dict(fusion=True, odom="gt"),
    "no fusion": dict(fusion=False),
}


@pytest.mark.parametrize("name", list(META_OPTIONS))
def test_step_runs_on_the_meta_device(name, uncaptured):
    dev = torch.device("meta")
    opts = TS.SLAMOptions(**META_OPTIONS[name])
    rgb = torch.empty((MB, MH, MW, 3), device=dev)
    depth = torch.empty((MB, MH, MW, 1), device=dev)
    K = torch.empty((MB, 1, 4, 4), device=dev)
    gt = torch.empty((MB, 4, 4), device=dev) if name == "gt odometry" else None
    labels = torch.empty((MB, MH, MW), dtype=torch.int32, device=dev) if name == "labels" else None
    state = TS.slam_init_state(rgb, depth, K, opts, 4 * MHW, labels=labels)
    new = TS.slam_step_state(state, rgb, depth, K, opts, gt, labels=labels)
    graph = stepgraph.StepGraph(opts, state, rgb, depth, K, gt, labels)
    graph.load(state, K)
    carry = graph.step(rgb, depth, gt, labels)
    assert carry is graph.carry
    for x, y in zip(stepgraph.state_tensors(new), stepgraph.state_tensors(carry)):
        assert (x is None) == (y is None)
        assert x is None or (x.shape == y.shape and x.dtype == y.dtype and y.device.type == "meta")
    with pytest.raises(Exception):
        int(new.map_state.num_points[0])  # a host read on meta raises


# ---------------------------------------------------------------------------
# the static-buffer step against the eager loop and JAX
# ---------------------------------------------------------------------------

SEQUENCES = {
    "exact knn L=3": (3, dict(fusion=True), False, False),
    "projective dense window L=10": (10, dict(fusion=True, assoc="projective", assoc_window=2 * H * W,
                                              model_rows="dense"), False, False),
    "gt odometry and labels L=3": (3, dict(fusion=True, odom="gt"), True, True),
    "no fusion L=3": (3, dict(fusion=False), False, False),
}


def _labels(L):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 20, (2, L, H, W)).astype(np.int32))


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_static_buffer_step_equals_the_eager_loop(clip, name, uncaptured):
    L, kw, gt, with_labels = SEQUENCES[name]
    rgb, depth, K, poses = _cycled(clip, L)
    labels = _labels(L) if with_labels else None
    opts = TS.SLAMOptions(**kw)
    cap = L * H * W
    lab = (lambda t: None) if labels is None else (lambda t: labels[:, t])
    state = TS.slam_init_state(rgb[:, 0], depth[:, 0], K, opts, cap, poses[:, 0] if gt else None, labels=lab(0))
    eager, eager_poses = state, [state.pose]
    for t in range(1, L):
        eager = TS.slam_step_state(eager, rgb[:, t], depth[:, t], K, opts, poses[:, t] if gt else None,
                                   labels=lab(t))
        eager_poses.append(eager.pose)
    gt_seq = poses if gt else None
    graph = stepgraph.StepGraph(opts, state, rgb[:, 1], depth[:, 1], K, None if gt_seq is None else gt_seq[:, 1],
                                None if labels is None else labels[:, 1])
    last, graph_poses = graph.run(state, rgb, depth, K, gt_seq, labels, 1, L)
    _assert_states_equal(last, eager)
    assert torch.equal(graph_poses, torch.stack(eager_poses[1:], dim=1))
    m, p = TS.slam_sequence(rgb, depth, K, poses if gt else None, opts, cap, labels_seq=labels)
    assert torch.equal(p[:, 1:], graph_poses) and torch.equal(m.data, last.map_state.data)


def _nn_stats(a, b):
    from scipy.spatial import cKDTree

    d = np.concatenate([cKDTree(b).query(a)[0], cKDTree(a).query(b)[0]])
    return np.median(d), np.percentile(d, 99)


def test_static_buffer_step_matches_jax(clip, uncaptured):
    """The gradICP clip through the graph's step function against JAX's
    ``slam_sequence``, with ``test_torch_parity.py``'s gradICP tolerances."""
    L = 3
    c, d, K = clip["colors"], clip["depths"], clip["intrinsics"]
    mj, pj = JS.slam_sequence(jnp.asarray(c), jnp.asarray(d), jnp.asarray(K), None,
                              JS.SLAMOptions(odom="gradicp", fusion=True), L * H * W)
    rgb, depth, Kt, _ = _cycled(clip, L)
    opts = TS.SLAMOptions(odom="gradicp", fusion=True)
    state = TS.slam_init_state(rgb[:, 0], depth[:, 0], Kt, opts, L * H * W)
    graph = stepgraph.StepGraph(opts, state, rgb[:, 1], depth[:, 1], Kt)
    last, poses = graph.run(state, rgb, depth, Kt, None, None, 1, L)
    assert np.abs(poses.numpy() - np.asarray(pj)[:, 1:]).max() < 2e-3
    nt, nj = last.map_state.num_points.numpy(), np.asarray(mj.num_points)
    assert np.all(np.abs(nt - nj) <= 0.05 * nj), (nt, nj)
    for b in range(2):
        med, p99 = _nn_stats(last.map_state.points[b, : nt[b]].numpy(), np.asarray(mj.points[b, : nj[b]]))
        assert med < 2e-4 and p99 < 1e-2, (b, med, p99)


# ---------------------------------------------------------------------------
# the winner kernel's key tables under replay
# ---------------------------------------------------------------------------


class _TableModel:
    """The winner kernel's use of its tables, modelled on CPU tensors: it
    checks that the table it folds into is all ones, resets ``n_other``
    entries of the other and leaves random entries of its own dirty."""

    def __init__(self, n):
        self.n, self.clean, self.rng = n, [], np.random.default_rng(0)

    def kernel(self, best, other, n_other):
        self.clean.append(bool((best[: self.n] == -1).all()))
        other[:n_other] = -1
        idx = torch.from_numpy(self.rng.integers(0, self.n, self.n // 3))
        best[idx] = torch.from_numpy(self.rng.integers(0, 2**62, idx.numel()))

    def call(self, wk, stream, capturing):
        """One wrapper call: eagerly it runs; captured, it returns the
        device operations a graph replays (the host code does not rerun)."""
        best, other, n_other, fill, done = wk.tables(self.n, torch.device("cpu"), stream, capturing)
        ops = ([lambda: best.fill_(-1)] if fill else []) + [lambda: self.kernel(best, other, n_other)]
        done()
        if capturing:
            return ops
        for op in ops:
            op()


def _replay(ops):
    for op in ops:
        op()


def test_every_replay_folds_into_a_clean_table():
    wk, model = _WinnerKernel(), _TableModel(1000)
    stream = 7
    model.call(wk, stream, capturing=False)  # the warm-up step, eagerly
    graph_a = model.call(wk, stream, capturing=True)
    graph_b = model.call(wk, stream, capturing=True)  # a second graph captured on the same stream
    for turn in ("a", "a", "eager", "b", "a", "eager", "eager", "b", "b", "a"):
        if turn == "eager":
            model.call(wk, stream, capturing=False)
        else:
            _replay(graph_a if turn == "a" else graph_b)
    assert len(model.clean) == 11 and all(model.clean)


def test_the_eager_schedule_would_fold_into_a_dirty_table_on_replay():
    """Why a captured call owns its table: the eager ping-pong captured
    once and replayed folds into the table its previous replay dirtied."""
    wk, model = _WinnerKernel(), _TableModel(1000)
    model.call(wk, 3, capturing=False)
    best, other, n_other, fill, done = wk.tables(model.n, torch.device("cpu"), 3, False)
    done()
    for _ in range(2):
        model.kernel(best, other, n_other)
    assert model.clean == [True, True, False]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_eager_reasons():
    x = torch.zeros(2, 3)
    assert stepgraph.eager_reason((x, None)) == "a cpu device"
    assert stepgraph.eager_reason((x, torch.zeros(2, requires_grad=True))) == "an input requires grad"
    assert stepgraph.eager_reason((x,), MapShard(None, 0, 2, 8)) == "a map-sharded arena"
    assert stepgraph.eager_reason((x,), MapShard.whole(8)) == "a cpu device"
    with disable_graphs():
        with disable_graphs():
            assert stepgraph.eager_reason((x,)) == "disable_graphs()"
        assert stepgraph.eager_reason((x,)) == "disable_graphs()"
    assert stepgraph.eager_reason((x,)) == "a cpu device"
    with pytest.raises(RuntimeError), disable_graphs():
        raise RuntimeError
    assert stepgraph.eager_reason((x,)) == "a cpu device"


@pytest.fixture
def graphs_on_cpu(monkeypatch, uncaptured):
    """Lifts the device rule alone: every other rule still sends a step to
    the eager loop, and the graph's function runs without a graph."""
    real = stepgraph.eager_reason

    def reason(tensors, shard=None):
        why = real(tensors, shard)
        return None if why == "a cpu device" else why

    monkeypatch.setattr(stepgraph, "eager_reason", reason)
    clear_graphs()
    yield stepgraph._SEQUENCES.graphs
    clear_graphs()


def test_slam_sequence_through_the_graph(clip, graphs_on_cpu):
    rgb, depth, K, _ = _cycled(clip, 6, step=2)
    opts = TS.SLAMOptions(fusion=True)
    cap = 6 * 60 * 80
    with disable_graphs():
        m0, p0 = TS.slam_sequence(rgb, depth, K, None, opts, cap)
    assert not graphs_on_cpu
    for _ in range(2):  # the second sequence replays the cached graph's function from a fresh carry
        m, p = TS.slam_sequence(rgb, depth, K, None, opts, cap)
        assert torch.equal(p, p0) and torch.equal(m.data, m0.data) and torch.equal(m.num_points, m0.num_points)
        assert len(graphs_on_cpu) == 1
    (graph,) = graphs_on_cpu.values()
    assert m.data.data_ptr() != graph.carry.map_state.data.data_ptr()  # the caller owns the result
    # a gradient runs eagerly and reaches the depth maps
    d = depth.clone().requires_grad_(True)
    _, pg = TS.slam_sequence(rgb, d, K, None, opts, cap)
    pg[:, -1, :3, 3].sum().backward()
    assert d.grad is not None and len(graphs_on_cpu) == 1
    clear_graphs()
    assert not graphs_on_cpu


def test_managed_segments_through_the_graph(clip, graphs_on_cpu):
    rgb, depth, K, _ = _cycled(clip, 7, step=2)
    opts = TS.SLAMOptions(fusion=True)
    kw = dict(capacity=int(1.5 * 60 * 80), segment_len=2, voxel_size=0.02)
    with disable_graphs():
        m0, p0 = lifecycle.slam_sequence_managed(rgb, depth, K, None, opts, **kw)
    m, p = lifecycle.slam_sequence_managed(rgb, depth, K, None, opts, **kw)
    assert len(graphs_on_cpu) >= 1
    assert torch.equal(p, p0) and torch.equal(m.data, m0.data) and torch.equal(m.num_points, m0.num_points)


def test_icpslam_step_state_through_the_graph(clip, graphs_on_cpu):
    rgb, depth, K, poses = (x.numpy() for x in _cycled(clip, 5, step=2))
    frame = lambda t: RGBDImages(rgb[:, t : t + 1], depth[:, t : t + 1], K, poses[:, t : t + 1], device="cpu")
    slam = PointFusion(device="cpu")
    state0 = slam.init_state(frame(0), capacity=5 * 60 * 80)
    eager = [state0]
    with disable_graphs():
        for t in range(1, 5):
            eager.append(slam.step_state(eager[-1], frame(t)))
    graphed = [state0]
    for t in range(1, 5):
        graphed.append(slam.step_state(graphed[-1], frame(t)))
    (graph,) = slam._graphs.graphs.values()
    carry = {x.data_ptr() for x in _fields(graph.carry)}
    for a, b in zip(graphed, eager):  # every state kept, none overwritten by a later step
        _assert_states_equal(a, b)
        assert not carry & {x.data_ptr() for x in _fields(a)}
    # two runs interleaved on one instance: each state its own
    a = slam.step_state(eager[1], frame(2))
    b = slam.step_state(eager[2], frame(3))
    _assert_states_equal(a, eager[2])
    _assert_states_equal(b, eager[3])
    assert len(slam._graphs.graphs) == 1 and not graphs_on_cpu


@pytest.mark.parametrize("odom", ["gradicp", "gt"])
def test_icpslam_step_through_the_graph(clip, graphs_on_cpu, odom):
    rgb, depth, K, poses = (x.numpy() for x in _cycled(clip, 4, step=2))
    frame = lambda t: RGBDImages(rgb[:, t : t + 1], depth[:, t : t + 1], K, poses[:, t : t + 1], device="cpu")
    slam = PointFusion(device="cpu", odom=odom)
    runs = []
    for graphed in (False, True):
        with (disable_graphs() if not graphed else __import__("contextlib").nullcontext()):
            m, p = init_map(2, 4 * 60 * 80, torch.float32, device="cpu"), None
            out = []
            for t in range(4):
                m, p = slam.step(m, frame(t), p)
                out.append((m.data.clone(), m.num_points.clone(), p.clone()))
        runs.append(out)
    for a, b in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sorted(k[0] for k in slam._graphs.graphs) == (["map"] if odom == "gt" else ["map", "slam"])


def test_graph_cache_keeps_the_graphs_used_last(monkeypatch):
    monkeypatch.setattr(stepgraph, "MAX_GRAPHS", 2)
    cache = stepgraph.GraphCache()
    made = []
    get = lambda k: cache.get(k, lambda: made.append(k) or k)
    for k in ("a", "b", "a", "c", "a", "b"):
        get(k)
    assert made == ["a", "b", "c", "b"]  # "b" was dropped for "c", "a" kept by its use
    assert list(cache.graphs) == ["a", "b"]
    clear_graphs()
    assert not cache.graphs
