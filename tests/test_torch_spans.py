"""The port's spans (``gradslam_tpu_torch/utils/profiling.py``) and the
benchmark's readers of them (``slam_bench/spans.py``, the ten
``slam_bench/metrics`` files that read marks).

On the CPU a span is a host range while a profiler runs and nothing else:
no device marks there. The marks' logic is held here by making the CPU
count as a device that takes marks (``marked`` fixture): ``_launch``
records each mark's name in order instead of launching its kernel. The
card tests at the end run the marks themselves, in a captured graph.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from gradslam_tpu_torch import GradStep, ICPSLAM, PointFusion, RGBDImages, clear_graphs
from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.slam import stepgraph
from gradslam_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data" / "msrd_b2s3"
OPTS = dict(odom="gradicp", numiters=2, dsratio=2, fusion=True)


def _clip(L=3, stride=4):
    """The golden clip cycled to ``L`` frames at every ``stride``-th pixel:
    (rgb, depth, K, poses) as (B, L, H, W, .) tensors."""
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= stride
    idx = [i % colors.shape[1] for i in range(L)]
    pick = lambda x: np.ascontiguousarray(x[:, idx, ::stride, ::stride])
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (pick(colors), pick(depths), K, poses[:, idx]))


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.fixture
def marked(monkeypatch):
    """The CPU takes marks: yields the list of mark names launched, in order."""
    launched = []
    monkeypatch.setattr(profiling, "_marks_on", lambda device: not profiling._marks_off)
    monkeypatch.setattr(profiling, "_launch", lambda mark, device: launched.append(mark))
    return launched


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """Lifts the device rule alone and runs a graph's function where the
    card would capture and replay it."""
    real = stepgraph.eager_reason

    def reason(tensors, shard=None, **kw):
        why = real(tensors, shard, **kw)
        return None if why == "a cpu device" else why

    monkeypatch.setattr(stepgraph._Captured, "__call__", lambda self, fn: fn())
    monkeypatch.setattr(stepgraph, "eager_reason", reason)
    clear_graphs()
    yield
    clear_graphs()


def _sequence(clip):
    rgb, depth, K, _ = clip
    return PointFusion(device="cpu", numiters=OPTS["numiters"], dsratio=OPTS["dsratio"])(
        RGBDImages(rgb, depth, K, device="cpu"))


def _online(clip):
    """init_state on frame 0, then step_state on each later frame: the poses."""
    rgb, depth, K, _ = clip
    slam = PointFusion(device="cpu", numiters=OPTS["numiters"], dsratio=OPTS["dsratio"])
    frame = lambda t: RGBDImages(rgb[:, t:t + 1], depth[:, t:t + 1], K, device="cpu")
    state = slam.init_state(frame(0))
    poses = [state.pose]
    for t in range(1, rgb.shape[1]):
        state = slam.step_state(state, frame(t))
        poses.append(state.pose)
    return state, torch.stack(poses, 1)


def _sgd(params, rgb, depth, K, gt, opts, capacity):
    loss = slam_loss(params, rgb, depth, K, gt, opts, capacity)
    g = torch.autograd.grad(loss, [params.scale, params.bias])
    with torch.no_grad():
        return params.scale - 0.1 * g[0], params.bias - 0.1 * g[1], loss.detach()


def _train(clip):
    rgb, depth, K, poses = clip
    L, H, W = rgb.shape[1:4]
    params = DepthCalibParams(1.05, 0.01, device="cpu")
    return GradStep(_sgd)(params, rgb, depth / 1.1, K, poses, TS.SLAMOptions(**OPTS), L * H * W)


def _host_spans(prof):
    """(name, start, end) of the port's host spans in a finished profile."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() in profiling.SPANS]


def _profiled(fn, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, _host_spans(prof)


def _parent(spans, child):
    """The name of the innermost span that encloses ``child``."""
    inside = [s for s in spans if s is not child and s[1] <= child[1] and child[2] <= s[2]]
    return min(inside, key=lambda s: s[2] - s[1])[0] if inside else None


def _nesting(spans):
    """{child name: set of its parents' names} and the count of each name."""
    parents, counts = {}, {}
    for s in spans:
        parents.setdefault(s[0], set()).add(_parent(spans, s))
        counts[s[0]] = counts.get(s[0], 0) + 1
    return parents, counts


# --- the one table -----------------------------------------------------------


def _literals(pattern, files):
    return {m for f in files for m in re.findall(pattern, f.read_text())}


def test_span_names_live_in_one_table():
    cu = (ROOT / "gradslam_tpu_torch" / "csrc" / "spans.cu").read_text()
    listed = re.search(r"#define GS_SPANS\(X\)(.*?)\n\n", cu, re.S).group(1)
    assert re.findall(r"X\((\w+)\)", listed) == [
        (s + kind).replace(".", "__") for s in profiling.DEVICE_SPANS for kind in ("", ".backward")]
    assert profiling.MARKS == tuple(
        f"gs_span_{edge}_{(s + kind).replace('.', '__')}" for s in profiling.DEVICE_SPANS
        for kind in ("", ".backward") for edge in ("begin", "end"))
    assert set(profiling.DEVICE_SPANS) <= set(profiling.SPANS)
    package = list((ROOT / "gradslam_tpu_torch").rglob("*.py"))
    used = _literals(r"\bspan(?:ned)?\(\"([^\"]+)\"", package) | _literals(r"graphed\(\s*\"([^\"]+)\"", package)
    assert used == set(profiling.SPANS)
    with pytest.raises(ValueError, match="no span named"):
        profiling.span("nowhere")


def test_the_readers_name_the_tables_marks_and_spans():
    metrics = ROOT / "slam_bench" / "metrics"
    readers = [metrics / f"{n}.py" for n in READERS]
    marks = _literals(r"\"(gs_span_\w+)\"", readers)
    assert marks and marks <= set(profiling.MARKS)
    host = _literals(r"HOST_SPANS = \(([^)]*)\)", readers)
    assert {n.strip(' "') for h in host for n in h.split(",") if n.strip()} == {"step_state", "init_state"}


# --- host spans --------------------------------------------------------------


def test_no_profiler_records_no_span(clip, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("recorded without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_launch", refuse)
    _sequence(clip)
    with profiling.span("odometry", torch.device("cpu")), profiling.annotate("anything"):
        pass


def test_profiled_sequence_spans_nest(clip):
    (_, poses), spans = _profiled(_sequence, clip)
    parents, counts = _nesting(spans)
    L = clip[0].shape[1]
    assert counts == {"slam_sequence": 1, "init_state": 1, "odometry": L - 1, "odometry.targets": L - 1,
                      "mapping": L}
    assert parents == {"slam_sequence": {None}, "init_state": {"slam_sequence"}, "odometry": {"slam_sequence"},
                       "odometry.targets": {"odometry"}, "mapping": {"init_state", "slam_sequence"}}
    assert torch.equal(poses, _sequence(clip)[1])  # the same outputs without the profiler


def test_profiled_step_state_spans_nest(clip, graphs_on_cpu):
    (state, poses), spans = _profiled(_online, clip)
    parents, counts = _nesting(spans)
    n = clip[0].shape[1] - 1
    assert counts == {"init_state": 1, "mapping": n + 1, "step_state": n, "step_state.handover": n,
                      "step_state.replay": n, "step_state.copy_out": n, "odometry": n, "odometry.targets": n,
                      "carry": n}
    assert parents == {"init_state": {None}, "step_state": {None}, "step_state.handover": {"step_state"},
                       "step_state.replay": {"step_state"}, "step_state.copy_out": {"step_state"},
                       "odometry": {"step_state.replay"}, "odometry.targets": {"odometry"},
                       "mapping": {"init_state", "step_state.replay"}, "carry": {"step_state.replay"}}
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    for h, r, c in zip(*(by_name[f"step_state.{k}"] for k in ("handover", "replay", "copy_out"))):
        assert h[2] <= r[1] and r[2] <= c[1]
    state2, poses2 = _online(clip)
    assert torch.equal(poses, poses2) and torch.equal(state.map_state.data, state2.map_state.data)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
def test_profiled_grad_step_spans_nest(clip, graphed, request):
    if graphed:
        request.getfixturevalue("graphs_on_cpu")
    (scale, bias, loss), spans = _profiled(_train, clip)
    parents, counts = _nesting(spans)
    L = clip[0].shape[1]
    body = "train.replay" if graphed else "GradStep"
    assert counts["GradStep"] == 1 and counts["slam_sequence"] == 1 and counts["odometry"] == L - 1
    assert parents["slam_sequence"] == {body} and parents["odometry"] == parents["init_state"] == {"slam_sequence"}
    assert ("train.handover" in parents) == graphed
    if graphed:
        assert parents["train.handover"] == parents["train.replay"] == {"GradStep"}
    assert torch.equal(loss, _train(clip)[2])


# --- device marks, on a CPU that takes them ----------------------------------


def _begin_end(name):
    return [profiling.mark_name(name, "begin"), profiling.mark_name(name, "end")]


def _frame_marks(carry):
    m = lambda n: profiling.mark_name(n, "begin")
    e = lambda n: profiling.mark_name(n, "end")
    return ([m("odometry"), *_begin_end("odometry.targets"), e("odometry"), *_begin_end("mapping")]
            + (_begin_end("carry") if carry else []))


def test_marks_in_order_and_outputs_equal(clip, marked, graphs_on_cpu):
    (state, poses) = _online(clip)
    init = [profiling.mark_name("init_state", "begin"), *_begin_end("mapping"),
            profiling.mark_name("init_state", "end")]
    n = clip[0].shape[1] - 1
    assert marked == init + _frame_marks(carry=True) * n
    assert len(_frame_marks(carry=True)) <= 12
    marked.clear()
    with profiling.device_spans(False):
        state2, poses2 = _online(clip)
    assert marked == []
    assert torch.equal(poses, poses2) and torch.equal(state.map_state.data, state2.map_state.data)
    assert torch.equal(state.map_state.num_points, state2.map_state.num_points)


def test_backward_marks_split_the_training_step(clip, marked):
    scale, bias, loss = _train(clip)
    backward = [m for m in marked if m.endswith("__backward")]
    forward = marked[:len(marked) - len(backward)]
    assert forward == [m for m in marked if not m.endswith("__backward")]  # the backward's marks come last
    L = clip[0].shape[1]
    assert forward == ([profiling.mark_name("init_state", "begin"), *_begin_end("mapping"),
                        profiling.mark_name("init_state", "end")] + _frame_marks(carry=False) * (L - 1))
    for name in ("odometry", "odometry.targets", "mapping", "init_state"):
        b, e = _begin_end(name + ".backward")
        assert backward.count(b) == backward.count(e) > 0
    # the last frame's map feeds no loss: its mapping's backward never runs
    assert backward.count(_begin_end("mapping.backward")[0]) == L - 1
    assert backward[0] == _begin_end("odometry.backward")[0]
    assert backward[-1] == _begin_end("init_state.backward")[1]
    marked.clear()
    with profiling.device_spans(False):
        scale2, bias2, loss2 = _train(clip)
    assert marked == []
    assert torch.equal(loss, loss2)  # the forward is the same to the bit
    # the backward's sums may group their terms otherwise
    torch.testing.assert_close((scale, bias), (scale2, bias2), rtol=1e-6, atol=0)


def _closure_run(marks=True):
    """ICP-SLAM with loop closure by both detectors over the golden clip
    cycled to 8 frames: its poses."""
    rgb, depth, K, _ = _clip(L=8)
    slam = ICPSLAM(device="cpu", numiters=2, dsratio=2, loop_closure="both",
                   loop_closure_kwargs=dict(min_separation=3, icp_numiters=2, dsratio=2, refine_iters=2))
    with profiling.device_spans(marks):
        return slam(RGBDImages(rgb, depth, K, device="cpu"))[1]


def _closure_marks():
    b = lambda n: profiling.mark_name(n, "begin")
    e = lambda n: profiling.mark_name(n, "end")
    return ([b("loop_closure")] + _begin_end("loop_closure.verify") * 2 + _begin_end("loop_closure.pose_graph")
            + [e("loop_closure")])


def test_closure_marks_nest_once_and_change_no_output(marked):
    poses = _closure_run()
    start = marked.index(profiling.mark_name("loop_closure", "begin"))
    # close_loops_rgbd's closure, clouds to pose graph: one loop_closure span
    assert marked[start:] == _closure_marks()
    assert all(not m.startswith("gs_span_begin_loop") for m in marked[:start])
    marked.clear()
    assert torch.equal(poses, _closure_run(marks=False)) and marked == []


# --- the benchmark's readers -------------------------------------------------

READERS = ("odometry_ms_per_frame.seq", "odometry_targets_ms_per_frame.seq", "mapping_ms_per_frame.seq",
           "forward_ms_per_step.train", "backward_ms_per_step.train", "step_idle_ms_per_frame.online",
           "closure_ms_per_sequence.loop", "closure_verify_ms_per_sequence.loop", "closure_knn_ms_per_sequence.loop",
           "pose_graph_ms_per_sequence.loop")


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "slam_bench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _ops(*rows):
    """Device operations from (name, start, end) rows in microseconds."""
    return [(n, float(s), float(e)) for n, s, e in rows]


def _mk(name, edge, t):
    return (profiling.mark_name(name, edge), t, t + 1)


SEQ_OPS = _ops(
    ("aten::copy", 0, 10),  # outside every span
    _mk("init_state", "begin", 10), _mk("mapping", "begin", 11),
    ("scan", 12, 20), ("fill", 15, 22),  # union 10
    _mk("mapping", "end", 22), _mk("init_state", "end", 23),
    _mk("odometry", "begin", 30), _mk("odometry.targets", "begin", 31),
    ("scan", 32, 36),
    _mk("odometry.targets", "end", 36),
    ("knn_cluster", 37, 45), ("crosses the end", 44, 47),
    _mk("odometry", "end", 46),
    _mk("mapping", "begin", 50), ("winner_grid", 51, 59), _mk("mapping", "end", 59),
    _mk("odometry", "begin", 60), _mk("odometry.targets", "begin", 61), ("scan", 62, 64),
    _mk("odometry.targets", "end", 64), _mk("odometry", "end", 65),
)


LOOP_OPS = _ops(
    ("sequence graph", 0, 100),  # before the closure
    _mk("loop_closure", "begin", 100), ("clouds", 101, 110),
    _mk("loop_closure.verify", "begin", 110), ("knn_cluster", 111, 115), ("solve", 115, 120),
    ("knn_cluster", 120, 124), _mk("loop_closure.verify", "end", 124),
    ("dedup", 125, 127),
    _mk("loop_closure.verify", "begin", 127), ("knn_cluster", 128, 140), _mk("loop_closure.verify", "end", 140),
    _mk("loop_closure.pose_graph", "begin", 141), ("gauss-newton", 142, 150),
    _mk("loop_closure.pose_graph", "end", 150), _mk("loop_closure", "end", 151),
    ("knn_cluster", 160, 170),  # the next sequence's odometry
)


@pytest.mark.parametrize("name, driver, record, expected", [
    # odometry: 4 + 8 (the op that crosses the end mark is left out) + 2 (the second frame), over 2 frames
    ("odometry_ms_per_frame.seq", "sequence", dict(device_ops=SEQ_OPS, frames=2), 14 / 1e3 / 2),
    ("odometry_targets_ms_per_frame.seq", "sequence", dict(device_ops=SEQ_OPS, frames=2), 6 / 1e3 / 2),
    ("mapping_ms_per_frame.seq", "sequence", dict(device_ops=SEQ_OPS, frames=2), 18 / 1e3 / 2),
    ("forward_ms_per_step.train", "train_step", dict(device_ops=SEQ_OPS + _ops(
        _mk("odometry.backward", "begin", 70), ("bwd", 71, 80), _mk("odometry.backward", "end", 80)), steps=1),
     # init_state's begin (ends 11) to the last end (starts 65): 10 + 4 + 10 (an odometry's end mark
     # inside the window takes nothing away) + 8 + 2
     34 / 1e3),
    ("backward_ms_per_step.train", "train_step", dict(device_ops=SEQ_OPS + _ops(
        _mk("odometry.backward", "begin", 70), ("bwd", 71, 80), _mk("odometry.backward", "end", 80),
        ("between", 81, 83), _mk("mapping.backward", "begin", 83), ("bwd", 84, 90),
        _mk("mapping.backward", "end", 90), _mk("init_state.backward", "begin", 91),
        _mk("init_state.backward", "end", 92), ("update", 93, 99)), steps=2), (9 + 2 + 6) / 1e3 / 2),
    ("step_idle_ms_per_frame.online", "online_step", dict(
        device_ops=_ops(("a", 0, 5), ("b", 12, 14), ("c", 13, 18), ("d", 30, 40)),
        host_ops=_ops(("init_state", 2, 10), ("step_state", 11, 20), ("step_state.replay", 12, 13),
                      ("step_state", 25, 35), ("bench.frame", 0, 40)), frame_steps=3),
     # init_state 2-10: 5 idle of 8; step_state 11-20: 1 + 2 idle; 25-35: 5 idle
     (5 + 3 + 5) / 1e3 / 3),
    # 9 (clouds) + 13 (the first verify) + 2 + 12 + 8 (marks left out), over 2 sequences
    ("closure_ms_per_sequence.loop", "loop_sequence", dict(device_ops=LOOP_OPS, sequences=2), 44 / 1e3 / 2),
    ("closure_verify_ms_per_sequence.loop", "loop_sequence", dict(device_ops=LOOP_OPS, sequences=2),
     (13 + 12) / 1e3 / 2),
    # the KNN kernels inside the verify spans: 4 + 4 + 12; the odometry's after the closure left out
    ("closure_knn_ms_per_sequence.loop", "loop_sequence", dict(device_ops=LOOP_OPS, sequences=1), 20 / 1e3),
    ("pose_graph_ms_per_sequence.loop", "loop_sequence", dict(device_ops=LOOP_OPS, sequences=1), 8 / 1e3),
])
def test_readers(name, driver, record, expected):
    read = _reader(name)
    base = dict(device_ops=[], host_ops=[], frames=1, frame_steps=1, steps=1, sequences=1)
    got = read({**base, **record, "driver": driver})
    assert got == pytest.approx(expected, rel=1e-12)
    # another cell's trace, and the parent's trace with no mark or span in it
    assert read({**base, **record, "driver": "elsewhere"}) is None
    plain = [r for r in record.get("device_ops", []) if not r[0].startswith("gs_span_")]
    host = [r for r in record.get("host_ops", []) if r[0] == "bench.frame"]
    assert read({**base, **record, "device_ops": plain, "host_ops": host, "driver": driver}) is None


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marks are CUDA kernels)")
    return torch.device("cuda", 0)


def _device_marks(fn):
    """``fn()``'s output and the names of the span marks the device ran, in
    the order they ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ops = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation())
    return out, [n for _, n in ops if n.startswith("gs_span_")]


@pytest.mark.cuda
def test_a_replay_runs_the_marks_in_capture_order_and_changes_no_output(card):
    rgb, depth, K, poses = (x.to(card) for x in _clip(L=4, stride=2))

    def run(marks):
        clear_graphs()
        slam = ICPSLAM(odom="gradicp", numiters=3, dsratio=2, device=card)
        frame = lambda t: RGBDImages(rgb[:, t:t + 1], depth[:, t:t + 1], K, device=card)
        with profiling.device_spans(marks):
            state = slam.init_state(frame(0))
            for t in (1, 2):  # warm-up and capture
                state = slam.step_state(state, frame(t))
        out, names = _device_marks(lambda: slam.step_state(state, frame(3)))
        return out, names

    with_marks, names = run(True)
    assert names == _frame_marks(carry=True)
    without, none = run(False)
    assert none == []
    for a, b in zip(stepgraph.state_tensors(with_marks), stepgraph.state_tensors(without)):
        assert (a is None and b is None) or torch.equal(a, b)
    clear_graphs()


@pytest.mark.cuda
def test_a_closure_graph_replays_its_marks_and_changes_no_output(card):
    rgb, depth, K, _ = (x.to(card) for x in _clip(L=30, stride=2))
    frames = RGBDImages(rgb, depth, K, device=card)

    def run(marks):
        clear_graphs()
        slam = ICPSLAM(odom_targets="recent", loop_closure="both", loop_closure_kwargs=dict(min_separation=10),
                       device=card)
        with profiling.device_spans(marks):  # frame 0 runs eagerly in every call
            for _ in range(2):  # warm-up and capture of both graphs
                slam(frames)
            return _device_marks(lambda: slam(frames)[1])

    poses, names = run(True)
    closure = names[names.index(profiling.mark_name("loop_closure", "begin")):]
    assert closure == _closure_marks()
    without, none = run(False)
    assert none == [] and torch.equal(poses, without)
    clear_graphs()
