"""Captured frame steps and training steps: the port's counterpart of the
JAX package's ``jax.jit`` + ``lax.scan`` + ``donate_argnums``, and of
``jax.jit(jax.value_and_grad(...))``.

The JAX package never runs its frame step op by op: ``slam_sequence`` is one
jitted ``lax.scan``, ``ICPSLAM.step`` jits its "map" and "slam" steps,
``ICPSLAM.step_state`` jits the step with the state donated, and the managed
run scans each segment. On a CUDA device the port captures the same step
once per set of static arguments as a ``torch.cuda.CUDAGraph`` and replays
it for every later frame: one host call for a step that runs thousands of
kernels op by op.

The static arguments are JAX's: the options, the shapes and dtypes of the
frame and of the carried state (so B, H, W and the capacity), whether there
are gt poses and labels, and the device. A captured step reads static
buffers. :class:`StepGraph` ends its step by copying the new state into its
static carry inside the graph, so one replay advances the carry: the
counterpart of ``donate_argnums``. What a caller gets back is always a copy
(one copy of the state a step for ``step_state``, one at the end of a
sequence), so a state kept from an earlier call is never overwritten, as a
jitted function gives fresh outputs. :class:`FrameGraph` (``ICPSLAM.step``)
keeps its outputs in the graph and hands out copies too; it also serves
``slam_sequence_compacted``, one graph of the whole run with its
compactions (the JAX package's one jitted scan of scans).

The JAX package never differentiates op by op either: its training steps
are ``jax.jit`` of ``jax.value_and_grad`` and an update. :class:`GradStep`
(and :func:`value_and_grad` on it) captures such a step whole as one
:class:`GradGraph`: the forward over every frame (recorded op by op, as
the frame step sees that it runs inside a capture with inputs that require
grad), the loss, ``torch.autograd.grad`` with respect to static leaf
tensors, and what the step does with the gradients (an SGD update). One
graph, not a graphed frame step replayed per frame: a replay of a frame's
graph would overwrite the tensors that the earlier frames saved for the
backward. Its pool holds every frame's saved tensors while a replay runs.

When the graph runs, and when the same function runs eagerly, op by op
(:func:`eager_reason`; a rule, not a fallback):

  - graphed on a CUDA device, outside :func:`disable_graphs`, when no input
    requires grad (a training step: whatever requires grad), on the whole
    arena (no ``shard``, or a group of one), on no mesh that runs a
    collective, and outside another capture;
  - eager on the CPU (no graphs there), for a gradient outside a training
    step (autograd records its own graph), on a map-sharded arena or a mesh
    that runs a collective (gloo collectives cannot be captured; NCCL's are
    not yet) and inside another graph's warm-up or capture (which then
    records the step itself, as ``jax.jit`` inlines a jitted function it
    calls).

A capture or a replay that fails raises; nothing reruns the step eagerly.

The first step of a new graph runs eagerly on a side stream: it builds the
kernels, queries the winner kernel's occupancy, creates the solver's
handles and warms the allocator, and advances the carry once; a training
step's warm-up runs its backward there too (autograd runs each backward op
on its forward op's stream). The next step captures (a capture runs no
work) and replays. Each graph records its kernels' launch counts while it
is captured and adds them to the counters of ``utils/cuda_build``'s
registry of counted kernels at every replay, so a run counts the launches
of the eager run (a backward launches none of the kernels).

The JAX package also jits its loop closure and its refiners, each a
``fori_loop`` of small ops: :func:`graphed` captures such a function of
tensors whole (``close_loops_batched``, ``close_loops_rgbd``, the detectors
and descriptors, ``pose_graph_refine``, ``ba_refine``, the managed run's
boundary closure), its non-tensor arguments static. A graphed function
called inside another graph's warm-up or capture runs eagerly there and is
recorded in the outer graph, as ``jax.jit`` inlines a jitted function it
calls.

The graphs are cached like JAX's compiled programs: module-level for
:func:`slam_sequence <gradslam_tpu_torch.slam.slam_sequence>` and the
managed segments and ``slam_sequence_compacted``, module-level apart from
those for the closures and refiners (so a closure never evicts the frame
step of the run it closes), per ``ICPSLAM`` instance for ``step`` and
``step_state``, per :class:`GradStep` for a training step. Unlike a
compiled program, a graph keeps device memory after its call returns: its
static carry (an arena) and frame buffers, and its private pool (one
step's intermediates; a training step's saved tensors of every frame). So
each cache holds the :data:`MAX_GRAPHS` graphs used last and frees the
others' memory when it drops them; :func:`clear_graphs` drops them all
(``jax.clear_caches``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import time
import weakref
from typing import Optional

import torch
import torch.distributed as dist

from ..structures.maparena import MapState
from ..utils.cuda_build import add_launch_counts, launch_counts, restore_launch_counts
from ..utils.profiling import span

__all__ = [
    "MAX_GRAPHS",
    "disable_graphs",
    "clear_graphs",
    "eager_reason",
    "GraphCache",
    "StepGraph",
    "FrameGraph",
    "GradGraph",
    "GradStep",
    "value_and_grad",
    "sequence_graph",
    "run_graph",
    "graphed",
    "running",
    "state_tensors",
]

# captured steps a cache keeps (the ones used last)
MAX_GRAPHS = 4

_disabled = 0
_running = 0  # graphs whose function runs now (a warm-up or a capture)


@contextlib.contextmanager
def disable_graphs():
    """Runs every frame step inside the block eagerly, op by op: the
    counterpart of ``jax.disable_jit()``."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


@contextlib.contextmanager
def running():
    """Marks a graph's function as running (its warm-up or its capture):
    a graphed function it calls runs eagerly and is recorded in it."""
    global _running
    _running += 1
    try:
        yield
    finally:
        _running -= 1


def eager_reason(tensors, shard=None, training=False, mesh=None) -> Optional[str]:
    """Why a step on these input ``tensors`` (None entries allowed) runs
    eagerly, or None when it runs as a captured graph.

    ``training``: the step is a :class:`GradStep`, whose graph holds its
    own backward, so inputs that require grad are what it captures.
    ``mesh``: the :class:`~gradslam_tpu_torch.parallel.Mesh` a step runs
    over; it runs collectives when an axis is larger than 1 or a process
    group is initialized (``Mesh.all_reduce`` then calls
    ``torch.distributed``).
    """
    if _disabled:
        return "disable_graphs()"
    tensors = [t for t in tensors if t is not None]
    if not training and any(t.requires_grad for t in tensors):
        return "an input requires grad"
    if shard is not None and shard.n > 1:
        return "a map-sharded arena"
    if mesh is not None and (mesh.shape["data"] > 1 or mesh.shape["map"] > 1 or dist.is_initialized()):
        return f"a mesh's collectives (data={mesh.shape['data']} x map={mesh.shape['map']})"
    if _running and not (tensors[0].is_cuda and torch.cuda.is_current_stream_capturing()):
        return "inside another graph's warm-up"
    if tensors[0].device.type != "cuda":
        return f"a {tensors[0].device.type} device"
    if torch.cuda.is_current_stream_capturing():
        return "inside another capture"
    return None


class GraphCache:
    """Captured steps by their static arguments, at most
    :data:`MAX_GRAPHS` of them: the ones used last. A dropped entry's
    buffers and graph pool are freed (nothing else refers to them).
    :func:`clear_graphs` empties every cache."""

    def __init__(self):
        self.graphs = collections.OrderedDict()
        _CACHES.add(self)

    def get(self, key, make):
        """The entry for ``key``, made by ``make()`` when missing."""
        if key in self.graphs:
            self.graphs.move_to_end(key)
        else:
            while len(self.graphs) >= MAX_GRAPHS:
                self.graphs.popitem(last=False)
            self.graphs[key] = make()
        return self.graphs[key]

    def clear(self):
        self.graphs.clear()


_CACHES = weakref.WeakSet()
_SEQUENCES = GraphCache()  # slam_sequence's, the managed segments' and slam_sequence_compacted's
# loop closure's and the refiners' (``graphed``): a closure never evicts the
# frame step of the run it closes
_CLOSURES = GraphCache()


def clear_graphs():
    """Drops every captured step and its buffers (module-level and per
    ``ICPSLAM`` instance): the counterpart of ``jax.clear_caches()``."""
    for cache in list(_CACHES):
        cache.clear()


class _Captured:
    """A function over static buffers on a CUDA device: run eagerly on a
    side stream at the first call, captured at the second and replayed from
    then on. The function is passed at each call (always the same one), so
    the graph holds no reference back to its owner."""

    def __init__(self, device: torch.device):
        self.device = device
        self.warm = False
        self.graph = None
        self.out = None
        self.launches = None  # per replay, {name: launches} of each counted kernel
        self.capture_s = None

    def __call__(self, fn):
        with torch.cuda.device(self.device):
            if not self.warm:
                with running():
                    return self._warm_up(fn)
            if self.graph is None:
                with running():
                    self._capture(fn)
            with span("graph.replay"):
                self.graph.replay()
        add_launch_counts(self.launches)
        return self.out

    def _warm_up(self, fn):
        here = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = fn()
        here.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(here)
        self.warm = True
        return out

    def _capture(self, fn):
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                out = fn()
        finally:
            # a capture launches nothing: its counts become the replays'
            captured = launch_counts()
            restore_launch_counts(before)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out = graph, out
        self.launches = {name: n - before[name] for name, n in captured.items()}


def _tensors(x):
    """The tensors of a step's output: a tensor, a MapState, or a tuple
    of them (a SLAMState), None entries left out."""
    if x is None or torch.is_tensor(x):
        return [] if x is None else [x]
    if isinstance(x, MapState):
        return [x.data, x.num_points]
    return [t for y in x for t in _tensors(y)]


def state_tensors(state):
    """A SLAMState's tensors, in field order (``model_rows`` may be None)."""
    m = state.map_state
    return [m.data, m.num_points, state.pose, state.cand_slots, state.cand_valid, state.app_start,
            state.model_img, state.model_rows]


def _signature(tensors):
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


def _buffer(t):
    return None if t is None else torch.empty_like(t, memory_format=torch.contiguous_format)


def _assign(dsts, srcs):
    """``dst.copy_(src)`` for each pair. A source that shares storage with a
    destination other than its own is copied first, so the copies read the
    old values whatever their order (a step returns the old ``num_points``
    as the new ``app_start``)."""
    held = {d.untyped_storage().data_ptr() for d in dsts if d is not None}
    srcs = [
        s if s is None or s is d or s.untyped_storage().data_ptr() not in held else s.clone()
        for d, s in zip(dsts, srcs)
    ]
    for d, s in zip(dsts, srcs):
        if d is not None and s is not d:
            d.copy_(s)


def _clone(x):
    """A copy of a step's output that no replay overwrites."""
    if x is None or torch.is_tensor(x):
        return None if x is None else x.clone()
    if isinstance(x, MapState):
        return MapState(x.data.clone(), x.num_points.clone())
    parts = [_clone(y) for y in x]
    return tuple(parts) if type(x) is tuple else type(x)(*parts)


class _Graph:
    """A captured function's seconds of capture and launches per replay."""

    _run: _Captured

    @property
    def capture_s(self) -> Optional[float]:
        """Seconds the capture took (None before it)."""
        return self._run.capture_s

    @property
    def launches(self):
        """Kernel calls per replay, one entry a counted wrapper by its name,
        ``{"knn": n, "winner": n, "mask_scan": n, "icp_system": n}`` (None
        before the capture)."""
        n = self._run.launches
        return None if n is None else dict(n)


class StepGraph(_Graph):
    """``slam_step_state`` for one set of static arguments, over static
    frame buffers and a static carry, captured on a CUDA device.

    :meth:`load` copies a state into the carry, :meth:`step` copies a
    frame into the frame buffers and runs one step, which leaves the new
    state in :attr:`carry`. :meth:`step_state` and :meth:`run` hand out
    copies of the carry.
    """

    def __init__(self, opts, state, rgb, depth, intrinsics, gt_pose=None, labels=None, shard=None):
        from .icpslam import SLAMState

        self.opts, self.shard = opts, shard
        bufs = [_buffer(t) for t in state_tensors(state)]
        self.carry = SLAMState(MapState(bufs[0], bufs[1]), *bufs[2:])
        self.rgb, self.depth, self.intrinsics, self.gt_pose, self.labels = (
            _buffer(t) for t in (rgb, depth, intrinsics, gt_pose, labels)
        )
        self._run = _Captured(rgb.device)

    @staticmethod
    def key(opts, state, rgb, depth, intrinsics, gt_pose=None, labels=None, shard=None):
        """The static arguments that select a graph."""
        sh = None if shard is None else (id(shard.group), shard.rank, shard.n, shard.capacity)
        return (opts, _signature(state_tensors(state)), _signature((rgb, depth, intrinsics, gt_pose, labels)),
                rgb.device, sh)

    def _step(self):
        from .icpslam import slam_step_state

        new = slam_step_state(self.carry, self.rgb, self.depth, self.intrinsics, self.opts, self.gt_pose,
                              labels=self.labels, shard=self.shard)
        with span("carry", self.carry.pose):
            _assign(state_tensors(self.carry), state_tensors(new))
        return self.carry

    def load(self, state, intrinsics):
        """Copies ``state`` into the carry and ``intrinsics`` into its buffer."""
        _assign(state_tensors(self.carry), state_tensors(state))
        self.intrinsics.copy_(intrinsics)

    def _frame(self, rgb, depth, gt_pose=None, labels=None):
        """Copies a frame into the frame buffers."""
        for buf, x in ((self.rgb, rgb), (self.depth, depth), (self.gt_pose, gt_pose), (self.labels, labels)):
            if buf is not None:
                buf.copy_(x)

    def step(self, rgb, depth, gt_pose=None, labels=None):
        """One frame step from the carry; returns the carry."""
        self._frame(rgb, depth, gt_pose, labels)
        return self._run(self._step)

    def step_state(self, state, rgb, depth, intrinsics, gt_pose=None):
        """One frame step from ``state``; returns a copy the caller owns."""
        with span("step_state.handover"):
            self.load(state, intrinsics)
            self._frame(rgb, depth, gt_pose)
        with span("step_state.replay"):
            carry = self._run(self._step)
        with span("step_state.copy_out"):
            return _clone(carry)

    def run(self, state, rgb_seq, depth_seq, intrinsics, poses_seq, labels_seq, t0: int, t1: int):
        """Frames ``[t0, t1)`` of (B, L, ...) sequences from ``state``.

        Returns:
            (the last state, a copy the caller owns; poses (B, t1 - t0, 4, 4)).
        """
        self.load(state, intrinsics)
        poses = self.carry.pose.new_empty((self.carry.pose.shape[0], t1 - t0, 4, 4))
        for t in range(t0, t1):
            self.step(rgb_seq[:, t], depth_seq[:, t],
                      None if self.gt_pose is None else poses_seq[:, t],
                      None if self.labels is None else labels_seq[:, t])
            poses[:, t - t0].copy_(self.carry.pose)
        return _clone(self.carry), poses


def sequence_graph(state, rgb_seq, depth_seq, intrinsics, poses_seq, opts, labels_seq=None,
                   shard=None) -> StepGraph:
    """The cached :class:`StepGraph` for a sequence's static arguments
    (``poses_seq`` is read only under gt odometry)."""
    frame = lambda x: None if x is None else x[:, 0]
    args = (opts, state, frame(rgb_seq), frame(depth_seq), intrinsics,
            frame(poses_seq) if opts.odom == "gt" else None, frame(labels_seq), shard)
    return _SEQUENCES.get(StepGraph.key(*args), lambda: StepGraph(*args))


def run_graph(name, fn, args, cache=None):
    """``fn(*args)`` through the :class:`FrameGraph` of ``cache`` (default
    the sequences' module-level cache) for ``name`` (the run's static
    arguments, hashable) and the arguments' shapes: a whole run captured as
    one graph."""
    cache = _SEQUENCES if cache is None else cache
    return cache.get(FrameGraph.key(name, args), lambda: FrameGraph(fn, args))(*args)


def graphed(name, fn, tensors, **static):
    """``fn(*tensors, **static)`` as the JAX package's ``jax.jit`` with
    ``static`` as its static arguments (ints, floats, strings, None, tuples
    of them): on a CUDA device, one :class:`FrameGraph` in the closures'
    module-level cache for ``name``, the static values, the tensors' shapes
    and dtypes (None entries allowed) and the device; by
    :func:`eager_reason`'s rules (the CPU, :func:`disable_graphs`, an input
    that requires grad, inside another graph) ``fn`` runs eagerly instead.
    A float gate is a static value: a graph bakes it in, so a changed gate
    makes a new graph. Loop closure and the refiners call it."""
    with span(name):
        if eager_reason(tensors) is not None:
            return fn(*tensors, **static)
        key = (name, tuple(sorted(static.items())))
        return run_graph(key, lambda *args: fn(*args, **static), tensors, cache=_CLOSURES)


class FrameGraph(_Graph):
    """A function of tensors (``ICPSLAM.step``'s "map" and "slam" steps, a
    whole ``slam_sequence_compacted`` run; None entries allowed) captured
    over static copies of its arguments; each call returns copies of its
    outputs, which the next replay overwrites in the graph."""

    def __init__(self, fn, args):
        self.fn = fn
        self.args = [_buffer(a) for a in args]
        self._run = _Captured(args[0].device)

    @staticmethod
    def key(name, args):
        return (name, _signature(args), args[0].device)

    def __call__(self, *args):
        _assign(self.args, args)
        return _clone(self._run(lambda: self.fn(*self.args)))


def _leaves(params):
    """The tensors a training step differentiates: an ``nn.Module``'s
    parameters, or ``params`` itself."""
    return list(params.parameters()) if isinstance(params, torch.nn.Module) else [params]


class GradGraph(_Graph):
    """One training step, ``step(params, *args)``, captured whole over
    static leaves (a copy of ``params``: a leaf tensor, or a copy of the
    module) and static copies of the tensor arguments; the other arguments
    are static values, part of the key. Each call copies ``params`` and the
    tensors in and returns copies of the step's outputs."""

    def __init__(self, step, params, args):
        self.step = step
        if isinstance(params, torch.nn.Module):
            self.params = copy.deepcopy(params)
        else:
            self.params = _buffer(params).requires_grad_(True)
        self.args = [_buffer(a) if torch.is_tensor(a) else a for a in args]
        self._run = _Captured(_leaves(params)[0].device)

    @staticmethod
    def key(params, args):
        """The static arguments that select a graph: the leaves' shapes and
        dtypes, each argument's (a tensor's shape and dtype, any other
        value itself) and the device."""
        leaves = _leaves(params)
        return (type(params), _signature(leaves),
                tuple(_signature([a])[0] if torch.is_tensor(a) else a for a in args), leaves[0].device)

    def __call__(self, params, *args):
        tensors = [(d, s) for d, s in zip(self.args, args) if torch.is_tensor(d)]
        with span("train.handover"), torch.no_grad():
            _assign(_leaves(self.params), _leaves(params))
            _assign([d for d, _ in tensors], [s for _, s in tensors])
        with span("train.replay"):
            out = self._run(lambda: self.step(self.params, *self.args))
        return _clone(out)


class GradStep:
    """``step(params, *args)`` run as the JAX package runs a jitted
    training step.

    ``step`` differentiates ``params`` (a tensor, or an ``nn.Module`` whose
    parameters are the leaves) with ``torch.autograd.grad``, never into
    ``.grad``, and returns tensors (one, or tuples of them) that do not
    require grad. ``args`` are tensors (None allowed) and static values
    (hashable: options, capacities). On a CUDA device each set of static
    arguments is one cached :class:`GradGraph` holding the forward, the
    loss, the backward and what ``step`` does with the gradients; by
    :func:`eager_reason`'s rules for a training step (the CPU,
    :func:`disable_graphs`, a map shard or a ``mesh`` that runs
    collectives, another capture) ``step`` runs eagerly instead. Either way
    the caller gets fresh tensors.
    """

    def __init__(self, step, mesh=None, shard=None):
        self.step, self.mesh, self.shard = step, mesh, shard
        self.graphs = GraphCache()

    def eager_reason(self, params, *args) -> Optional[str]:
        """Why a call on these arguments runs eagerly (None: as a graph)."""
        tensors = _leaves(params) + [a for a in args if torch.is_tensor(a)]
        return eager_reason(tensors, self.shard, training=True, mesh=self.mesh)

    def __call__(self, params, *args):
        with span("GradStep"):
            if self.eager_reason(params, *args) is not None:
                if not isinstance(params, torch.nn.Module):
                    params = params.detach().requires_grad_(True)
                return self.step(params, *args)
            graph = self.graphs.get(GradGraph.key(params, args), lambda: GradGraph(self.step, params, args))
            return graph(params, *args)


def value_and_grad(fn) -> GradStep:
    """``jax.jit(jax.value_and_grad(fn))``: ``fn(params, *args)`` returns a
    0-d loss; the result, called with the same arguments, returns ``(loss,
    grads)`` as fresh tensors, ``grads`` a tensor for a tensor ``params``
    and a tuple in ``params.parameters()`` order for a module. On a CUDA
    device one captured graph a set of static arguments (:class:`GradStep`)."""

    def step(params, *args):
        loss = fn(params, *args)
        grads = torch.autograd.grad(loss, _leaves(params))
        return loss.detach(), grads if isinstance(params, torch.nn.Module) else grads[0]

    return GradStep(step)
