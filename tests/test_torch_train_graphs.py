"""The captured training step (``gradslam_tpu_torch/slam/stepgraph.py``:
``GradGraph``, ``GradStep``, ``value_and_grad``) on the CPU.

A CUDA graph exists only on the card; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 33 capture and replay the training step there.
Here the graph's function runs where the card would capture and replay it
(the ``uncaptured`` fixture), with the device rule lifted
(``graphs_on_cpu``), as ``tests/test_torch_graphs.py`` does for the frame
step. Inputs: the golden clip strided 4x (30x40), B=2, L=3, gradICP with 5
iterations.

- the training graph's path gives ``slam_loss`` and its two gradients
  bit-equal to eager ``torch.autograd.grad``, and within 1e-3 relative of
  ``jax.jit(jax.value_and_grad(slam_loss))`` (``tests/test_torch_calib.py``'s
  tolerance);
- two ``sharded_train_step`` steps on a one-process mesh through the graph
  match JAX's ``sharded_train_step`` on one CPU device within rtol 1e-4
  (``tests/test_torch_sharded.py``'s), and parameters kept from one step are
  unchanged by the next;
- ``slam_sequence_compacted``'s forward through its graph is bit-equal to
  its eager loop, and its gradient through ``value_and_grad`` matches
  ``jax.grad`` within ``tests/test_torch_lifecycle_grad.py``'s 2.6e-5 of
  JAX's largest value (at that file's inputs);
- the rules that send a training step to the eager loop, and the cache
  entries that new static arguments make.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.parallel import DepthCalibParams as JParams
from gradslam_tpu.parallel import make_mesh as j_make_mesh
from gradslam_tpu.parallel.sharded import sharded_train_step as j_sharded_train_step
from gradslam_tpu.parallel.sharded import slam_loss as j_slam_loss
from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu.slam import lifecycle as JL
from gradslam_tpu_torch import GradStep, clear_graphs, disable_graphs, value_and_grad
from gradslam_tpu_torch.parallel import DepthCalibParams, make_mesh, sharded_train_step, slam_loss
from gradslam_tpu_torch.parallel.mesh import Mesh
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.slam import lifecycle as TL
from gradslam_tpu_torch.slam import stepgraph

torch.set_num_threads(2)

DATA = __import__("pathlib").Path(__file__).parent / "data" / "msrd_b2s3"
OPTS = dict(odom="gradicp", numiters=5, dsratio=2, fusion=True)
SCALE, BIAS = 1.05, 0.01
LR = 1e3  # the gradient is ~1e-6: a step moves the parameters by ~1e-3
# tests/test_torch_lifecycle_grad.py's inputs: 30x40, B=1, L=6, projective
# gradICP, a voxel merge of 2**-6 m at every second frame
COMPACTED_OPTS = dict(odom="gradicp", numiters=4, dsratio=4, fusion=True, assoc="projective")
COMPACTED_KW = dict(segment_len=2, policy="voxel", voxel_size=2.0**-6)


def _clip(L=3, stride=4, B=2):
    """The golden clip's first ``B`` entries cycled to ``L`` frames, every
    ``stride``-th pixel, as numpy: (colors, depths, K, poses)."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= stride
    idx = [i % colors.shape[1] for i in range(L)]
    pick = lambda x: np.ascontiguousarray(x[:B][:, idx])
    return (np.ascontiguousarray(pick(colors)[:, :, ::stride, ::stride]),
            np.ascontiguousarray(pick(depths)[:, :, ::stride, ::stride]), np.ascontiguousarray(K[:B]), pick(poses))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.fixture(scope="module")
def clip():
    colors, depths, K, poses = _clip()
    return colors, depths / 1.1, K, poses


@pytest.fixture
def uncaptured(monkeypatch):
    """Runs a graph's function where the card would capture and replay it."""
    monkeypatch.setattr(stepgraph._Captured, "__call__", lambda self, fn: fn())


@pytest.fixture
def graphs_on_cpu(monkeypatch, uncaptured):
    """Lifts the device rule alone: every other rule still sends a step to
    the eager loop, and the graph's function runs without a graph."""
    real = stepgraph.eager_reason

    def reason(tensors, shard=None, **kw):
        why = real(tensors, shard, **kw)
        return None if why == "a cpu device" else why

    monkeypatch.setattr(stepgraph, "eager_reason", reason)
    clear_graphs()
    yield
    clear_graphs()


def _loss_args(clip):
    colors, depths, K, poses = clip
    L, H, W = colors.shape[1:4]
    return (*_torch(colors, depths, K, poses), TS.SLAMOptions(**OPTS), L * H * W)


@pytest.fixture(scope="module")
def jax_value_and_grad(clip):
    colors, depths, K, poses = clip
    L, H, W = colors.shape[1:4]
    fn = jax.jit(jax.value_and_grad(j_slam_loss), static_argnames=("opts", "capacity"))
    params = JParams(scale=jnp.asarray(SCALE, jnp.float32), bias=jnp.asarray(BIAS, jnp.float32))
    loss, g = fn(params, *(jnp.asarray(x) for x in (colors, depths, K, poses)), opts=JS.SLAMOptions(**OPTS),
                 capacity=L * H * W)
    return float(loss), np.array([float(g.scale), float(g.bias)])


def _graphed_value_and_grad(clip):
    """``value_and_grad(slam_loss)`` twice through its graph's function (the
    card's capture, then a replay): (the GradStep, [(loss, grads), ...])."""
    vg = value_and_grad(slam_loss)
    params = DepthCalibParams(SCALE, BIAS, device="cpu")
    args = _loss_args(clip)
    assert vg.eager_reason(params, *args) is None
    return vg, [vg(params, *args) for _ in range(2)]


def test_training_graph_equals_eager_autograd_grad(clip, graphs_on_cpu):
    params = DepthCalibParams(SCALE, BIAS, device="cpu")
    loss = slam_loss(params, *_loss_args(clip))
    grads = torch.autograd.grad(loss, [params.scale, params.bias])
    vg, outs = _graphed_value_and_grad(clip)
    (graph,) = vg.graphs.graphs.values()
    assert isinstance(graph, stepgraph.GradGraph)
    for got_loss, got_grads in outs:
        assert not got_loss.requires_grad and torch.equal(got_loss, loss.detach())
        assert len(got_grads) == 2 and all(torch.equal(a, b) for a, b in zip(got_grads, grads))
    # the caller's parameters get no .grad: the graph differentiates its own leaves
    assert params.scale.grad is None
    with disable_graphs():
        eager_loss, eager_grads = vg(params, *_loss_args(clip))
    assert torch.equal(eager_loss, loss.detach()) and all(torch.equal(a, b) for a, b in zip(eager_grads, grads))
    assert params.scale.grad is None and len(vg.graphs.graphs) == 1


def test_training_graph_matches_jax(clip, graphs_on_cpu, jax_value_and_grad):
    loss_j, grad_j = jax_value_and_grad
    _, outs = _graphed_value_and_grad(clip)
    loss, grads = outs[-1]
    assert abs(float(loss) - loss_j) <= 1e-3 * abs(loss_j)
    g = np.array([float(x) for x in grads])
    assert np.all(grad_j != 0) and np.abs(g - grad_j).max() <= 1e-3 * np.abs(grad_j).max(), (g, grad_j)


@pytest.fixture(scope="module")
def jax_train(clip):
    """JAX's ``sharded_train_step`` on one CPU device: two steps' losses and
    parameters."""
    colors, depths, K, poses = clip
    L, H, W = colors.shape[1:4]
    step = j_sharded_train_step(j_make_mesh(data=1, map_=1, devices=jax.devices()[:1]), JS.SLAMOptions(**OPTS),
                                L * H * W, lr=LR)
    params = JParams(scale=jnp.asarray(SCALE, jnp.float32), bias=jnp.asarray(BIAS, jnp.float32))
    out = []
    for _ in range(2):
        params, loss = step(params, *(jnp.asarray(x) for x in (colors, depths, K, poses)))
        out.append((float(loss), float(params.scale), float(params.bias)))
    return np.array(out)


def test_sharded_train_step_through_the_graph_matches_jax(clip, graphs_on_cpu, jax_train):
    colors, depths, K, poses = clip
    L, H, W = colors.shape[1:4]
    step = sharded_train_step(make_mesh(device="cpu"), TS.SLAMOptions(**OPTS), L * H * W, lr=LR)
    params = DepthCalibParams(SCALE, BIAS, device="cpu")
    assert step.train.eager_reason(params) is None
    out = []
    for _ in range(2):
        params, loss = step(params, *_torch(colors, depths, K, poses))
        assert isinstance(params, DepthCalibParams) and params.scale.requires_grad
        out.append((float(loss), float(params.scale.detach()), float(params.bias.detach())))
    out = np.array(out)
    assert len(step.train.graphs.graphs) == 1
    np.testing.assert_allclose(out[:, 0], jax_train[:, 0], rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(out[:, 1], jax_train[:, 1], rtol=1e-4)
    np.testing.assert_allclose(out[:, 2], jax_train[:, 2], rtol=1e-4, atol=1e-7)
    assert (out[:, 1] != SCALE).all() and out[1, 1] != out[0, 1], "the scale did not move"
    # the same two steps op by op
    params = DepthCalibParams(SCALE, BIAS, device="cpu")
    with disable_graphs():
        for i in range(2):
            params, loss = step(params, *_torch(colors, depths, K, poses))
            assert (float(loss), float(params.scale.detach()), float(params.bias.detach())) == tuple(out[i])


def test_kept_parameters_are_not_overwritten_by_the_next_step(clip, graphs_on_cpu):
    colors, depths, K, poses = clip
    L, H, W = colors.shape[1:4]
    step = sharded_train_step(make_mesh(device="cpu"), TS.SLAMOptions(**OPTS), L * H * W, lr=LR)
    p0 = DepthCalibParams(SCALE, BIAS, device="cpu")
    p1, loss1 = step(p0, *_torch(colors, depths, K, poses))
    kept = [p1.scale.clone(), p1.bias.clone(), loss1.clone()]
    p2, loss2 = step(p1, *_torch(colors, depths, K, poses))
    assert torch.equal(p1.scale, kept[0]) and torch.equal(p1.bias, kept[1]) and torch.equal(loss1, kept[2])
    assert not torch.equal(p2.scale, p1.scale)
    (graph,) = step.train.graphs.graphs.values()
    static = {t.data_ptr() for t in graph.params.parameters()}
    assert not static & {t.data_ptr() for t in (p1.scale, p1.bias, p2.scale, p2.bias, loss1, loss2)}
    assert p0.scale.item() == np.float32(SCALE)
    # value_and_grad's outputs too
    vg = value_and_grad(slam_loss)
    args = _loss_args(clip)
    a = vg(p0, *args)
    kept = [a[0].clone(), *(g.clone() for g in a[1])]
    b = vg(p2, *args)
    assert all(torch.equal(x, y) for x, y in zip([a[0], *a[1]], kept))
    assert not torch.equal(a[1][0], b[1][0])


def _compacted_inputs():
    colors, depths, K, _ = _clip(L=6, B=1)
    H, W = colors.shape[2:4]
    return _torch(colors, depths, K), TS.SLAMOptions(**COMPACTED_OPTS), 2 * H * W


def test_compacted_forward_through_the_graph_equals_the_eager_loop(graphs_on_cpu):
    (rgb, depth, K), opts, cap = _compacted_inputs()
    with disable_graphs():
        m0, p0, peak0 = TL.slam_sequence_compacted(rgb, depth, K, None, opts, cap, **COMPACTED_KW)
    assert not stepgraph._SEQUENCES.graphs
    for _ in range(2):  # the card's capture, then a replay of the cached graph
        m, p, peak = TL.slam_sequence_compacted(rgb, depth, K, None, opts, cap, **COMPACTED_KW)
        assert torch.equal(m.data, m0.data) and torch.equal(m.num_points, m0.num_points)
        assert torch.equal(p, p0) and torch.equal(peak, peak0) and peak.dim() == 0
    (key, graph), = stepgraph._SEQUENCES.graphs.items()
    assert key[0][0] == "slam_sequence_compacted" and isinstance(graph, stepgraph.FrameGraph)
    # a gradient runs op by op, outside the graph
    d = depth.clone().requires_grad_(True)
    _, pg, _ = TL.slam_sequence_compacted(rgb, d, K, None, opts, cap, **COMPACTED_KW)
    assert pg.requires_grad and len(stepgraph._SEQUENCES.graphs) == 1


def test_compacted_gradient_through_the_training_graph_matches_jax(graphs_on_cpu):
    (rgb, depth, K), opts, cap = _compacted_inputs()

    def jloss(dj):
        _, poses, _ = JL.slam_sequence_compacted(jnp.asarray(rgb.numpy()), dj, jnp.asarray(K.numpy()), None,
                                                 JS.SLAMOptions(**COMPACTED_OPTS), cap, **COMPACTED_KW)
        return jnp.sum(poses[..., :3, 3] ** 2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(depth.numpy())))

    def loss(d, rgb, K):
        _, poses, _ = TL.slam_sequence_compacted(rgb, d, K, None, opts, cap, **COMPACTED_KW)
        return (poses[..., :3, 3] ** 2).sum()

    vg = value_and_grad(loss)
    _, g = vg(depth, rgb, K)
    assert len(vg.graphs.graphs) == 1 and not stepgraph._SEQUENCES.graphs  # recorded inside the training graph
    assert depth.grad is None and not g.requires_grad
    with disable_graphs():
        _, g_eager = vg(depth, rgb, K)
    assert torch.equal(g, g_eager)
    gt = g.numpy()
    per_frame = np.abs(gt).reshape(gt.shape[1], -1).sum(axis=1)
    assert np.isfinite(gt).all() and (per_frame[1:] > 0).all(), per_frame
    assert np.abs(gt - gj).max() <= 2.6e-5 * np.abs(gj).max(), np.abs(gt - gj).max() / np.abs(gj).max()


def _fake_cuda(requires_grad):
    """What ``eager_reason`` reads of a tensor, on a CUDA device."""
    return types.SimpleNamespace(requires_grad=requires_grad, device=torch.device("cuda", 0))


def test_training_eager_reasons(monkeypatch):
    x = torch.zeros(2, requires_grad=True)
    assert stepgraph.eager_reason((x,), training=True) == "a cpu device"
    with disable_graphs():
        assert stepgraph.eager_reason((x,), training=True) == "disable_graphs()"
    groups = {None: None, "data": None, "map": None}
    for d, m in ((2, 1), (1, 2), (2, 2)):
        mesh = Mesh(d, m, 0, torch.device("cpu"), groups)
        assert stepgraph.eager_reason((x,), training=True, mesh=mesh) == f"a mesh's collectives (data={d} x map={m})"
    # on the card (a CUDA tensor): a training step captures inputs that
    # require grad, a frame step does not; inside a capture both run eagerly
    t = _fake_cuda(True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert stepgraph.eager_reason((t,)) == "an input requires grad"
    assert stepgraph.eager_reason((t,), training=True) is None
    assert stepgraph.eager_reason((t,), training=True, mesh=make_mesh(device="cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert stepgraph.eager_reason((t,), training=True) == "inside another capture"
    assert stepgraph.eager_reason((_fake_cuda(False),)) == "inside another capture"


def test_sharded_train_step_runs_eagerly_on_a_mesh_with_collectives(clip, graphs_on_cpu):
    """data > 1 and map > 1 meshes (built here without a process group)
    name their collectives; the one-process mesh takes the graph."""
    colors, _, _, _ = clip
    L, H, W = colors.shape[1:4]
    params = DepthCalibParams(device="cpu")
    groups = {None: None, "data": None, "map": None}
    opts = TS.SLAMOptions(**OPTS)
    for (d, m), why in (((2, 1), "a mesh's collectives (data=2 x map=1)"), ((1, 2), "a map-sharded arena")):
        step = sharded_train_step(Mesh(d, m, 0, torch.device("cpu"), groups), opts, L * H * W)
        assert step.train.eager_reason(params) == why
    assert sharded_train_step(make_mesh(device="cpu"), opts, L * H * W).train.eager_reason(params) is None
    with disable_graphs():
        assert sharded_train_step(make_mesh(device="cpu"), opts, L * H * W).train.eager_reason(params) == (
            "disable_graphs()")


def test_new_static_arguments_make_new_graphs(graphs_on_cpu):
    vg = value_and_grad(slam_loss)
    params = DepthCalibParams(SCALE, BIAS, device="cpu")
    made = lambda: len(vg.graphs.graphs)

    def call(L=2, B=1, numiters=2):
        colors, depths, K, poses = _clip(L=L, stride=8, B=B)
        H, W = colors.shape[2:4]
        return vg(params, *_torch(colors, depths, K, poses), TS.SLAMOptions(**dict(OPTS, numiters=numiters)),
                  L * H * W)

    call()
    call()
    assert made() == 1
    for n, kw in enumerate((dict(B=2), dict(L=3), dict(numiters=3)), start=2):
        call(**kw)
        assert made() == n
    keys = list(vg.graphs.graphs)
    assert len({k[2] for k in keys}) == 4  # the arguments' shapes and statics tell them apart
    # lr: baked into a sharded step (one graph a step function), read from a
    # device tensor by a GradStep (the schedule replays one graph)
    colors, depths, K, poses = _clip(L=2, stride=8, B=1)
    H, W = colors.shape[2:4]
    args = _torch(colors, depths, K, poses)
    opts = TS.SLAMOptions(**dict(OPTS, numiters=2))
    steps = [sharded_train_step(make_mesh(device="cpu"), opts, 2 * H * W, lr=lr) for lr in (LR, 2 * LR)]
    moved = [float(s(params, *args)[0].scale.detach()) - SCALE for s in steps]
    assert [len(s.train.graphs.graphs) for s in steps] == [1, 1]
    assert moved[1] == pytest.approx(2 * moved[0], rel=1e-3)

    def sgd(p, lr):
        loss = slam_loss(p, *args, opts, 2 * H * W)
        (g,) = torch.autograd.grad(loss, [p.scale])
        with torch.no_grad():
            return p.scale - lr * g
    step = GradStep(sgd)
    lr = torch.zeros(())
    out = []
    for value in (LR, 2 * LR):
        lr.fill_(value)
        out.append(float(step(params, lr)) - SCALE)
    assert len(step.graphs.graphs) == 1 and out[1] == pytest.approx(2 * out[0], rel=1e-3)


def test_training_graph_cache_keeps_the_graphs_used_last(monkeypatch, graphs_on_cpu):
    monkeypatch.setattr(stepgraph, "MAX_GRAPHS", 2)
    step = GradStep(lambda p, x: torch.autograd.grad((p * x.sum()).sum(), [p]))
    p = torch.ones(3)
    for n in (1, 2, 3, 2):
        (g,) = step(p, torch.full((n,), 2.0))
        assert torch.equal(g, torch.full((3,), 2.0 * n))
    assert [k[2][0][0] for k in step.graphs.graphs] == [(3,), (2,)]
    clear_graphs()
    assert not step.graphs.graphs


def test_grad_step_on_the_meta_device(uncaptured):
    """The training step has no host read: the loss and its gradients on
    the meta device, whose tensors raise on a host read."""
    dev = torch.device("meta")
    B, L, H, W = 2, 2, 16, 16
    params = DepthCalibParams(device="cpu").to(dev)
    rgb = torch.empty((B, L, H, W, 3), device=dev)
    depth = torch.empty((B, L, H, W, 1), device=dev)
    K = torch.empty((B, 1, 4, 4), device=dev)
    gt = torch.empty((B, L, 4, 4), device=dev)
    graph = stepgraph.GradGraph(lambda p, *a: stepgraph.value_and_grad(slam_loss).step(p, *a), params,
                                (rgb, depth, K, gt, TS.SLAMOptions(**OPTS), L * H * W))
    loss, grads = graph(params, rgb, depth, K, gt, TS.SLAMOptions(**OPTS), L * H * W)
    assert loss.device.type == "meta" and loss.shape == () and [g.shape for g in grads] == [(), ()]
    with pytest.raises(Exception):
        float(loss)
