"""Profiling and the port's spans (PyTorch port of gradslam_tpu.utils.profiling).

This module is the port's one tracing system. A *span* names one layer of
the program for the length of a call, in two places at once:

- **On the host**, a ``torch.profiler.record_function`` range, recorded
  only while a profiler runs; otherwise a span costs one flag check. The
  profiler writes it among its host events, on the clock of the device's
  activity, nested in the span that encloses it.
- **On the device**, for the spans of :data:`DEVICE_SPANS` on a CUDA
  device, a begin and an end *mark*: an empty kernel from ``csrc/spans.cu``
  whose name carries the span's (:func:`mark_name`: ``gs_span_begin_odometry``,
  ``gs_span_end_odometry__targets``; a dot becomes ``__``), launched on the
  current stream. A mark launched while a CUDA graph is captured becomes a
  node of the graph, so every replay writes it into the device trace, in
  capture order, between the layer's kernels: a host range around a replay
  cannot split the work of one graph launch, the marks do. Where a span's
  inputs require grad, an identity ``autograd.Function`` at its entry and
  exit emits ``<name>.backward`` marks from the backward, so the backward
  of a captured training step is split by layer too. A mark reads and
  writes no tensor: outputs are the same with and without marks (the
  backward's sums may group their terms otherwise, to the last bit).

The spans (:data:`SPANS`, the one table of their names):

- device and host: ``init_state`` (the first frame's mapping into a fresh
  arena), ``odometry`` (localization, ``_localize`` and
  ``_localize_projective``) and its child ``odometry.targets`` (the
  targets' projection and compaction, up to the rows gathered; none inside
  ICP's iterations), ``mapping`` (``_map_update``), ``carry``
  (``StepGraph``'s copy of the new state into its static carry);
  ``loop_closure`` (a whole closure: ``_close_loops_rgbd``'s frame clouds
  and descriptors, or ``_close_loops_batched`` alone, through the pose
  graph) with its children ``loop_closure.verify`` (a detector's batched
  gradICP solve and its inlier KNN) and ``loop_closure.pose_graph``
  (``pose_graph_refine``'s iterations);
- host only: ``slam_sequence``; ``step_state`` with ``step_state.handover``
  (state and frame into the static buffers), ``step_state.replay`` and
  ``step_state.copy_out`` (the caller's copy of the new state);
  ``graph.replay`` (a captured graph's launch); ``GradStep`` with
  ``train.handover`` and ``train.replay``; and one span for each function
  that ``stepgraph.graphed`` runs (loop closure, its detectors and
  descriptors, ``pose_graph_refine``, ``ba_refine``), named after it.

Taking a trace of one's own run (``logdir`` then holds a trace that
TensorBoard's profiler plugin and Perfetto open)::

    from gradslam_tpu_torch.utils import profiling

    with profiling.trace("logdir"):
        poses = slam(frames)[1]
        profiling.sync(poses)

A graph replays the marks it was captured with. :func:`device_spans`
(False) captures graphs, and runs eager steps, without marks (the host
spans stay): the way to measure what the marks cost.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .cuda_build import CudaLibrary

__all__ = [
    "trace",
    "annotate",
    "span",
    "spanned",
    "device_spans",
    "mark_name",
    "SPANS",
    "DEVICE_SPANS",
    "MARKS",
    "DeviceTimer",
    "sync",
]

# every span of the port: name -> what it covers
SPANS = {
    "init_state": "the first frame mapped into a fresh arena (slam_init_state)",
    "odometry": "localization of a frame (_localize, _localize_projective)",
    "odometry.targets": "the odometry targets' projection and compaction, up to the rows gathered",
    "mapping": "the frame fused or aggregated into the arena (_map_update)",
    "carry": "StepGraph's copy of the new state into its static carry",
    "loop_closure": "a whole loop closure: frame clouds, descriptors, detection, verification, dedup, pose graph",
    "loop_closure.verify": "a detector's batched gradICP verification and its inlier KNN",
    "loop_closure.pose_graph": "the closure's pose-graph Gauss-Newton (pose_graph_refine)",
    "slam_sequence": "a whole sequence (slam_sequence)",
    "step_state": "one incremental step (ICPSLAM.step_state)",
    "step_state.handover": "state and frame copied into the step's static buffers",
    "step_state.replay": "the step's graph run (warm-up, capture or replay)",
    "step_state.copy_out": "the copy of the new state that the caller owns",
    "graph.replay": "one launch of a captured graph",
    "GradStep": "one training step (GradStep)",
    "train.handover": "parameters and tensors copied into the training graph's static buffers",
    "train.replay": "the training graph run (warm-up, capture or replay)",
    # the functions stepgraph.graphed runs, by the names their callers give
    "detect_loop_closures": "loop detection by poses (graphed)",
    "keyframe_descriptors": "keyframe descriptors (graphed)",
    "keyframe_descriptors_invariant": "rotation-invariant keyframe descriptors (graphed)",
    "detect_loop_closures_descriptor": "loop detection by descriptors (graphed)",
    "close_loops_batched": "loop closure of a batch of trajectories (graphed)",
    "close_loops_rgbd": "loop closure from RGB-D frames (graphed)",
    "slam_sequence_managed closure": "the managed run's closure of the trajectory so far (graphed)",
    "pose_graph_refine": "the pose graph's Gauss-Newton refinement (graphed)",
    "ba_refine": "bundle adjustment (graphed)",
}
# the spans that also mark the device, in the order of csrc/spans.cu's GS_SPANS
DEVICE_SPANS = ("init_state", "odometry", "odometry.targets", "mapping", "carry", "loop_closure",
                "loop_closure.verify", "loop_closure.pose_graph")


def mark_name(span_name: str, edge: str) -> str:
    """The CUDA function name of a span's ``edge`` ("begin" or "end") mark."""
    return f"gs_span_{edge}_{span_name.replace('.', '__')}"


# every mark kernel, in csrc/spans.cu's order: its index is the id the library launches
MARKS = tuple(mark_name(s + kind, edge) for s in DEVICE_SPANS for kind in ("", ".backward")
              for edge in ("begin", "end"))
_MARK_IDS = {m: i for i, m in enumerate(MARKS)}

_marks_off = 0  # device_spans(False) blocks open now


@contextlib.contextmanager
def device_spans(enabled: bool = True):
    """With ``enabled`` False, spans inside the block launch no device
    marks (and add no identity to autograd): graphs captured in the block
    replay without them. Host spans are unchanged."""
    global _marks_off
    _marks_off += 0 if enabled else 1
    try:
        yield
    finally:
        _marks_off -= 0 if enabled else 1


def _marks_on(device: torch.device) -> bool:
    return not _marks_off and device.type == "cuda"


class _MarkLibrary(CudaLibrary):
    """``csrc/spans.cu``'s library: built at the first mark, one launch of
    an empty kernel a mark on the current stream."""

    source = "spans.cu"
    entries = {"gst_span_marks": [], "gst_span_mark": [ctypes.c_int, ctypes.c_void_p]}

    def load(self):
        fns = super().load()
        if fns["gst_span_marks"]() != len(MARKS):
            self._fns = None
            raise RuntimeError(f"{self.source} has {fns['gst_span_marks']()} marks, the table {len(MARKS)}")
        return fns


_library = _MarkLibrary()


def _launch(mark: str, device: torch.device) -> None:
    """Launches ``mark`` on ``device``'s current stream."""
    _library.invoke("gst_span_mark", device, _MARK_IDS[mark])


class _Span:
    """A host range while a profiler runs, and a mark at each end on
    ``device`` (None: no marks)."""

    __slots__ = ("name", "device", "_range")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name, self.device = name, device

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device is not None:
            _launch(mark_name(self.name, "begin"), self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None and exc[0] is None:
            _launch(mark_name(self.name, "end"), self.device)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, device=None) -> _Span:
    """The port's span ``name`` (a key of :data:`SPANS`) over a block: a
    host range while a profiler runs and, for a device span on a CUDA
    ``device`` (a ``torch.device`` or a tensor on it), a mark at each end."""
    if name not in SPANS:
        raise ValueError(f"no span named {name!r} in profiling.SPANS")
    if torch.is_tensor(device):
        device = device.device
    marked = name in DEVICE_SPANS and device is not None and _marks_on(torch.device(device))
    return _Span(name, torch.device(device) if marked else None)


def annotate(name: str) -> _Span:
    """Named trace span (context manager) for profiler timelines: any
    name, a host range while a profiler runs."""
    return _Span(name)


class _BackwardMark(torch.autograd.Function):
    """The identity on the tensors it is given; its backward launches a
    mark. At a span's exit it launches ``<name>.backward``'s begin mark (its
    backward runs before the span's), at its entry the end mark."""

    @staticmethod
    def forward(mark, device, *xs):
        return xs

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark, ctx.device = inputs[0], inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *grads):
        _launch(ctx.mark, ctx.device)
        return (None, None, *grads)


def _through(mark: str, device: torch.device, tree):
    """``tree`` with its tensors that require grad passed through one
    :class:`_BackwardMark` (``tree`` itself when none does)."""
    grads = list({id(t): t for t in _tensors(tree) if t.requires_grad}.values())
    if not grads:
        return tree
    return _replace(tree, dict(zip((id(t) for t in grads), _BackwardMark.apply(mark, device, *grads))))


def _replace(tree, new: dict):
    """``tree`` with each tensor ``t`` whose ``id`` is a key of ``new``
    replaced by ``new[id(t)]``; parts with nothing replaced are kept as
    they are."""
    if torch.is_tensor(tree):
        return new.get(id(tree), tree)
    if isinstance(tree, dict):
        out = {k: _replace(v, new) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    if isinstance(tree, (tuple, list)):
        parts = [_replace(v, new) for v in tree]
        if all(a is b for a, b in zip(parts, tree)):
            return tree
        if isinstance(tree, list):
            return parts
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changed = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            r = _replace(v, new)
            if r is not v:
                changed[f.name] = r
        return dataclasses.replace(tree, **changed) if changed else tree
    return tree


def spanned(name: str):
    """Decorates a function with the span ``name``. A device span marks the
    device of the first tensor among the arguments; where its arguments
    require grad (and grad is on), its backward is marked too."""
    if name not in SPANS:
        raise ValueError(f"no span named {name!r} in profiling.SPANS")
    device_span = name in DEVICE_SPANS

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            first = next(_tensors(args), None) if device_span else None
            device = first.device if first is not None and _marks_on(first.device) else None
            with _Span(name, device):
                if device is None or not torch.is_grad_enabled():
                    return fn(*args, **kwargs)
                args, kwargs = _through(mark_name(name + ".backward", "end"), device, (args, kwargs))
                return _through(mark_name(name + ".backward", "begin"), device, fn(*args, **kwargs))

        return wrapper

    return decorate


def _tensors(tree):
    """The tensors among ``tree``'s leaves (nested tuples, lists, dicts,
    named tuples and dataclasses such as ``MapState``)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree=None) -> None:
    """Waits for the work producing ``tree``: synchronizes every CUDA device
    that holds one of its tensors (the current device when ``tree`` is
    None and a card is present)."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """Captures a ``torch.profiler`` trace of the host and, with a card, the
    device into ``log_dir`` (view with TensorBoard or Perfetto); yields the
    profiler. The port's spans appear in it by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


class DeviceTimer:
    """Walltime timer with device synchronization.

    Example:
        >>> with DeviceTimer("fusion") as t:
        ...     out = step(x)
        ...     t.sync(out)
        >>> t.elapsed
    """

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, tree):
        sync(tree)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")
        return False
