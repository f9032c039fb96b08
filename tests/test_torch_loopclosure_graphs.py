"""The captured loop closure and refiners (``slam/stepgraph.graphed``) on
the CPU.

A CUDA graph exists only on the card; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 34 capture and replay these functions there. Here
each graph's function runs where the card would capture and replay it (the
``uncaptured`` fixture, which marks it as running, as a warm-up or a
capture does), with the device rule lifted (``graphs_on_cpu``), as
``tests/test_torch_graphs.py`` and ``tests/test_torch_train_graphs.py`` do
for the frame step and the training step. Inputs: the synthetic loops of
``tests/test_torch_loopclosure.py`` and ``tests/test_torch_pose_refine.py``
and the golden clip at 30x40.

- ``close_loops_batched``, ``close_loops``, ``close_loops_rgbd``,
  ``pose_graph_refine``, ``ba_refine`` (dense and 'pcg'), the detectors and
  the descriptors through their graphs: bit-equal to the eager run and
  within ``TOL = 1e-5`` of their JAX twins (the tolerance of
  ``test_torch_loopclosure.py`` and ``test_torch_pose_refine.py``);
- ``examples_torch/train_loopclosure_ate.py``'s step through
  ``value_and_grad`` and ``GradStep``: equal to eager ``autograd.grad`` and
  within 1e-3 relative of ``jax.value_and_grad`` of the JAX example's loss;
- ``ICPSLAM(loop_closure=...)`` and the managed run's closures through
  their graphs, bit-equal to eager;
- the rules that run a call eagerly, the cache entries that new static
  arguments make, the closures' own cache, and ``clear_graphs()``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradslam_tpu.slam as J
import tests.parallel.test_pose_refine as JPT
import tests.slam.test_loopclosure as JT
from gradslam_tpu.metrics import ate_rmse as j_ate_rmse
from gradslam_tpu.parallel import pose_refine as JP
from gradslam_tpu.slam import loopclosure as JL
from gradslam_tpu_torch import ICPSLAM, GradStep, RGBDImages, clear_graphs, disable_graphs, value_and_grad
from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine
from gradslam_tpu_torch.slam import (
    SLAMOptions,
    close_loops,
    close_loops_batched,
    close_loops_rgbd,
    detect_loop_closures,
    detect_loop_closures_descriptor,
    keyframe_descriptors,
    keyframe_descriptors_invariant,
    slam_sequence,
    slam_sequence_managed,
    stepgraph,
)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data" / "msrd_b2s3"
TOL = 1e-5
BOTH = dict(max_candidates=3, min_separation=5, max_distance=0.3, icp_numiters=12, refine_iters=6,
            detection="both", appearance_init="identity")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _flat(x):
    return stepgraph._tensors(x)


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def uncaptured(monkeypatch):
    """Runs a graph's function where the card would capture and replay it,
    marked as running: a graphed function that it calls runs eagerly and is
    recorded in it, as at a warm-up and a capture."""

    def run(self, fn):
        with stepgraph.running():
            return fn()

    monkeypatch.setattr(stepgraph._Captured, "__call__", run)


@pytest.fixture
def graphs_on_cpu(monkeypatch, uncaptured):
    """Lifts the device rule alone: every other rule still runs a call
    eagerly, and the graph's function runs without a graph. Yields the
    closures' cache."""
    real = stepgraph.eager_reason

    def reason(tensors, shard=None, **kw):
        why = real(tensors, shard, **kw)
        return None if why == "a cpu device" else why

    monkeypatch.setattr(stepgraph, "eager_reason", reason)
    clear_graphs()
    yield stepgraph._CLOSURES.graphs
    clear_graphs()


def _names(cache):
    return sorted(key[0][0] for key in cache)


def _through_graph(cache, fn, entries=1):
    """``fn()`` eagerly, then twice through its graph's function: both
    bit-equal to the eager result, a fresh copy each, ``entries`` cache
    entries. Returns the eager result."""
    with disable_graphs():
        ref = fn()
    assert not cache
    first = fn()
    again = fn()
    _assert_equal(first, ref)
    _assert_equal(again, ref)
    assert len(cache) == entries, _names(cache)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(_flat(first), _flat(again)))
    return ref


def _batch(seeds=(0, 7)):
    items = [JT._make_loop(seed=s, drift=0.03) for s in seeds]
    arrays = [np.stack([np.asarray(it[i]) for it in items]) for i in range(5)]
    return arrays, _t(*arrays)


# ---------------------------------------------------------------------------
# loop closure
# ---------------------------------------------------------------------------


def test_close_loops_batched_through_the_graph(graphs_on_cpu):
    (_, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = _batch()
    with disable_graphs():
        descs = keyframe_descriptors_invariant(tpts, tnrm, tval)
    got = _through_graph(graphs_on_cpu, lambda: close_loops_batched(tdr, tpts, tnrm, tval, descriptors=descs, **BOTH))
    assert _names(graphs_on_cpu) == ["close_loops_batched"]
    assert bool((got[2] > 0).any())
    jdescs = jnp.stack([J.keyframe_descriptors_invariant(*(jnp.asarray(a[b]) for a in (pts, nrm, val)))
                        for b in range(2)])
    ref = J.close_loops_batched(*(jnp.asarray(a) for a in (dr, pts, nrm, val)), descriptors=jdescs, **BOTH)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=TOL)
    np.testing.assert_array_equal(got[1].edges.numpy(), np.asarray(ref[1].edges))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_close_loops_through_the_graph(graphs_on_cpu):
    (tp, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = JT._make_loop(), _t(*JT._make_loop())
    kw = dict(max_candidates=4, min_separation=5, max_distance=0.3)
    got = _through_graph(graphs_on_cpu, lambda: close_loops(tdr, tpts, tnrm, tval, **kw))
    assert _names(graphs_on_cpu) == ["close_loops_batched"]  # close_loops is a batch of one
    ref = J.close_loops(dr, pts, nrm, val, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def _sequence(ds=4, n=8):
    """The golden clip cycled to ``n`` frames at every ``ds``-th pixel, with
    its poses."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    idx = [i % colors.shape[1] for i in range(n)]
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= ds
    pick = lambda x: np.ascontiguousarray(x[:, idx])
    return (np.ascontiguousarray(pick(colors)[:, :, ::ds, ::ds]), np.ascontiguousarray(pick(depths)[:, :, ::ds, ::ds]),
            K, pick(poses))


@pytest.mark.parametrize("descriptor", ["invariant", "grid"])
def test_close_loops_rgbd_through_the_graph(graphs_on_cpu, descriptor):
    """One graph of the clouds, the descriptors and the closure: the inner
    graphed calls record themselves in it and make no entry of their own."""
    colors, depths, K, poses = _sequence()
    kw = dict(detection="both", min_separation=2, max_distance=0.5, max_candidates=2, descriptor=descriptor)
    rgb, dep, Kt, tp = _t(colors, depths, K, poses)
    got = _through_graph(graphs_on_cpu, lambda: close_loops_rgbd(rgb, dep, Kt, tp, **kw))
    assert _names(graphs_on_cpu) == ["close_loops_rgbd"]
    ref = JL.close_loops_rgbd(*(jnp.asarray(a) for a in (colors, depths, K, poses)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_detectors_and_descriptors_through_their_graphs(graphs_on_cpu):
    (_, dr, pts, nrm, val), (_, tdr, tpts, tnrm, tval) = (JT._make_loop(), _t(*JT._make_loop()))
    colors, depths, K, _ = _sequence(n=3)
    dep = torch.from_numpy(depths[0, ..., 0])
    nm = torch.nn.functional.normalize(torch.from_numpy(np.random.default_rng(0).normal(
        size=dep.shape + (3,)).astype(np.float32)), dim=-1)
    valid = dep > 0
    cases = (
        ("detect_loop_closures", lambda: detect_loop_closures(tdr, max_candidates=4, min_separation=5,
                                                              max_distance=0.3),
         lambda: J.detect_loop_closures(dr, max_candidates=4, min_separation=5, max_distance=0.3)),
        ("keyframe_descriptors_invariant", lambda: keyframe_descriptors_invariant(tpts, tnrm, tval),
         lambda: J.keyframe_descriptors_invariant(pts, nrm, val)),
        ("keyframe_descriptors", lambda: keyframe_descriptors(dep, nm, valid),
         lambda: J.keyframe_descriptors(*(jnp.asarray(x.numpy()) for x in (dep, nm, valid)))),
    )
    for name, run, jax_run in cases:
        clear_graphs()
        got = _through_graph(graphs_on_cpu, run)
        assert _names(graphs_on_cpu) == [name]
        ref = jax_run()
        if isinstance(got, tuple):
            np.testing.assert_array_equal(got.edges.numpy(), np.asarray(ref.edges))
            np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    clear_graphs()
    with disable_graphs():
        desc = keyframe_descriptors_invariant(tpts, tnrm, tval)
    kw = dict(max_candidates=4, min_separation=2, max_descriptor_dist=0.5)
    got = _through_graph(graphs_on_cpu, lambda: detect_loop_closures_descriptor(desc, **kw))
    assert _names(graphs_on_cpu) == ["detect_loop_closures_descriptor"]
    ref = J.detect_loop_closures_descriptor(jnp.asarray(desc.numpy()), **kw)
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(ref.edges))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


# ---------------------------------------------------------------------------
# refiners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_pose_graph_refine_through_the_graph(graphs_on_cpu, batched):
    graphs = [JPT.make_graph(np.random.RandomState(s), L=8, noise=0.05)[0] for s in (1, 2)]
    arrays = [np.stack([np.asarray(g[i]) for g in graphs]) if batched else np.asarray(graphs[0][i])
              for i in range(4)]
    tg = PoseGraph(*_t(*arrays))
    got = _through_graph(graphs_on_cpu, lambda: pose_graph_refine(tg, num_iters=10))
    assert _names(graphs_on_cpu) == ["pose_graph_refine"]
    for b in range(2 if batched else 1):
        ref = JP.pose_graph_refine(graphs[b], num_iters=10)
        np.testing.assert_allclose((got[b] if batched else got).numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_refine_through_the_graph(graphs_on_cpu, solver):
    _, _, init_poses, init_lms, obs_pose, obs_lm, obs_pts = JPT.make_ba_problem(np.random.RandomState(0), L=5, M=40,
                                                                               obs_per_lm=3)
    args = _t(init_poses, init_lms, obs_pose, obs_lm, obs_pts)
    kw = dict(num_iters=4, damping=1e-6, solver=solver, cg_iters=32)
    got = _through_graph(graphs_on_cpu, lambda: ba_refine(*args, **kw))
    ((name, static),) = [k[0] for k in graphs_on_cpu]
    # the host's observation count is a static argument of the dense graph
    assert name == "ba_refine" and dict(static)["true_max"] == (3 if solver == "dense" else 0)
    ref = JP.ba_refine(*(jnp.asarray(a) for a in (init_poses, init_lms, obs_pose, obs_lm, obs_pts)), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


# ---------------------------------------------------------------------------
# callers
# ---------------------------------------------------------------------------


def test_icpslam_with_closure_replays_both_graphs(graphs_on_cpu):
    """A second sequence of the same shape goes through the cached frame
    step and closure graphs: bit-equal to the eager run."""
    colors, depths, K, _ = _sequence(n=6)
    kw = dict(odom="gradicp", numiters=4, loop_closure="both", device="cpu",
              loop_closure_kwargs=dict(min_separation=2, max_candidates=2, max_distance=0.5))
    rgbd = RGBDImages(colors, depths, K, device="cpu")
    with disable_graphs():
        pcs0, p0 = ICPSLAM(**kw)(rgbd)
    for _ in range(2):
        pcs, p = ICPSLAM(**kw)(rgbd)
        assert torch.equal(p, p0) and torch.equal(pcs.points_padded, pcs0.points_padded)
    assert _names(graphs_on_cpu) == ["close_loops_rgbd"]
    assert len(stepgraph._SEQUENCES.graphs) == 1


def test_managed_closures_through_their_graphs(graphs_on_cpu):
    """One graph a boundary's length (t = 4, then the whole run's 7), the
    frame step's graph in the sequences' cache; a second run reuses them."""
    colors, depths, K, _ = _sequence(n=7)
    rgb, dep, Kt = _t(colors, depths, K)
    L, H, W = colors.shape[1:4]
    opts = SLAMOptions(odom="gradicp", numiters=4, fusion=True)
    kw = dict(capacity=L * H * W, segment_len=3, loop_closure="both",
              loop_closure_kwargs=dict(min_separation=2, max_candidates=2, max_distance=0.5))
    with disable_graphs():
        m0, p0 = slam_sequence_managed(rgb, dep, Kt, None, opts, **kw)
    for _ in range(2):
        m, p = slam_sequence_managed(rgb, dep, Kt, None, opts, **kw)
        assert torch.equal(p, p0) and torch.equal(m.data, m0.data)
        assert _names(graphs_on_cpu) == ["slam_sequence_managed closure"] * 2
    shapes = sorted(key[1][0][0][1] for key in graphs_on_cpu)
    assert shapes == [4, 7]
    assert len(stepgraph._SEQUENCES.graphs) >= 1


def _example():
    path = ROOT / "examples_torch" / "train_loopclosure_ate.py"
    spec = importlib.util.spec_from_file_location("train_loopclosure_ate_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_loopclosure_ate_step_through_the_graph(graphs_on_cpu):
    """The example's loss at its defaults through ``value_and_grad`` and its
    ``GradStep`` (the closure recorded inside the training graph): equal to
    eager ``autograd.grad`` and within 1e-3 relative of JAX's."""
    ex = _example()
    problem = ex.make_problem(13, 256, 0.02, 1.15, 0, torch.device("cpu"))
    log_s = torch.zeros(())
    leaf = log_s.clone().requires_grad_(True)
    loss0, w0 = ex.loss_fn(leaf, *problem)
    (g0,) = torch.autograd.grad(loss0, [leaf])
    vg = value_and_grad(lambda p, *args: ex.loss_fn(p, *args)[0])
    for _ in range(2):
        loss, g = vg(log_s, *problem)
        assert torch.equal(loss, loss0.detach()) and torch.equal(g, g0)
    lr = torch.full((), 0.4)
    step = GradStep(ex.sgd)
    for _ in range(2):
        new, loss, w = step(log_s, lr, *problem)
        assert torch.equal(loss, loss0.detach()) and torch.equal(w, w0) and torch.equal(new, log_s - lr * g0)
    assert not graphs_on_cpu  # the closure's inputs require grad: recorded in the training graph
    assert len(vg.graphs.graphs) == 1 and len(step.graphs.graphs) == 1

    dr, pts, nrm, val, gt = (jnp.asarray(x.numpy()) for x in problem)
    L = dr.shape[0]

    def jax_loss(s):
        refined, _, _ = J.close_loops(dr, jnp.exp(s) * pts, nrm, val, max_candidates=8, min_separation=max(3, L // 3),
                                      max_distance=0.3, icp_numiters=8, refine_iters=5)
        return j_ate_rmse(refined, gt, align=False)

    jl, jg = jax.value_and_grad(jax_loss)(jnp.zeros(()))
    assert abs(float(loss) - float(jl)) <= 1e-3 * abs(float(jl))
    assert abs(float(g) - float(jg)) <= 1e-3 * abs(float(jg))


# ---------------------------------------------------------------------------
# rules and caches
# ---------------------------------------------------------------------------


def test_eager_reasons(graphs_on_cpu):
    """The rules that run a graphed function eagerly: no entry is made."""
    g = PoseGraph(*_t(*JPT.make_graph(np.random.RandomState(1), L=6)[0]))
    with disable_graphs():
        pose_graph_refine(g, num_iters=2)
    with stepgraph.running():
        assert stepgraph.eager_reason(tuple(g)) == "inside another graph's warm-up"
        pose_graph_refine(g, num_iters=2)
    grad = g._replace(measurements=g.measurements.clone().requires_grad_(True))
    assert stepgraph.eager_reason(tuple(grad)) == "an input requires grad"
    pose_graph_refine(grad, num_iters=2)
    assert not graphs_on_cpu
    pose_graph_refine(g, num_iters=2)
    assert len(graphs_on_cpu) == 1


def test_the_cpu_runs_eagerly():
    g = PoseGraph(*_t(*JPT.make_graph(np.random.RandomState(1), L=6)[0]))
    clear_graphs()
    assert stepgraph.eager_reason(tuple(g)) == "a cpu device"
    pose_graph_refine(g, num_iters=2)
    assert not stepgraph._CLOSURES.graphs


def test_new_static_arguments_make_new_entries(graphs_on_cpu):
    g = PoseGraph(*_t(*JPT.make_graph(np.random.RandomState(1), L=6)[0]))
    runs = (dict(num_iters=2), dict(num_iters=3), dict(num_iters=3, damping=1e-5), dict(num_iters=2))
    for n, kw in zip((1, 2, 3, 3), runs):
        pose_graph_refine(g, **kw)
        assert len(graphs_on_cpu) == n
    pose_graph_refine(g._replace(poses=g.poses.double(), measurements=g.measurements.double(),
                                 weights=g.weights.double()), num_iters=2)
    assert len(graphs_on_cpu) == 4  # the dtype is part of the key
    statics = [dict(k[0][1]) for k in graphs_on_cpu]
    assert {(s["num_iters"], s["damping"]) for s in statics} == {(2, 1e-6), (3, 1e-6), (3, 1e-5)}


def test_a_closure_does_not_evict_the_frame_step(graphs_on_cpu):
    colors, depths, K, _ = _sequence(n=3)
    rgb, dep, Kt = _t(colors, depths, K)
    L, H, W = colors.shape[1:4]
    slam_sequence(rgb, dep, Kt, None, SLAMOptions(fusion=True), L * H * W)
    (frame_step,) = stepgraph._SEQUENCES.graphs.values()
    g = PoseGraph(*_t(*JPT.make_graph(np.random.RandomState(1), L=6)[0]))
    for n in range(stepgraph.MAX_GRAPHS + 2):
        pose_graph_refine(g, num_iters=n + 1)
    assert len(graphs_on_cpu) == stepgraph.MAX_GRAPHS
    assert list(stepgraph._SEQUENCES.graphs.values()) == [frame_step]


def test_clear_graphs_empties_the_closures_cache(graphs_on_cpu):
    g = PoseGraph(*_t(*JPT.make_graph(np.random.RandomState(1), L=6)[0]))
    pose_graph_refine(g, num_iters=2)
    assert len(graphs_on_cpu) == 1
    clear_graphs()
    assert not graphs_on_cpu
