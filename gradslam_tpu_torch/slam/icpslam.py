"""ICP-SLAM, the end-to-end dense SLAM driver (PyTorch port of
gradslam_tpu.slam.icpslam).

A localize-then-map loop over frames whose body never waits on the host (no
``.item()``, no data-dependent shapes). On a CUDA device that body is
captured once per set of static arguments as a CUDA graph and replayed for
every frame after the first (``slam/stepgraph.py``: the counterpart of the
JAX package's ``jax.jit`` + ``lax.scan``); elsewhere, under a gradient or on
a map-sharded arena it runs as a Python loop, op by op.

  - Localization projects the live map (or the candidate rows carried from
    the previous fusion step) into the previous frame, keeps the points on
    the ``dsratio`` pixel grid, compacts them into a fixed-size target
    buffer and runs the batched gradICP / ICP solver with the KNN kernel;
    with ``assoc='projective'`` it instead associates each source point
    with the model image that the previous fusion step left at its pixel.
  - Mapping is the PointFusion update (or the append-only aggregate) of
    the fixed-capacity arena.

Given a :class:`~gradslam_tpu_torch.slam.mapshard.MapShard` (``shard``),
the arena is this rank's part of one partitioned by slot over a process
group: the candidate rows are assembled on every rank of the group, so the
odometry runs on identical inputs everywhere, and the fusion step selects
winners per rank and across the group. ``shard=None`` is the whole arena on
one process (:meth:`MapShard.whole`), through the same code.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import compose_transformations
from ..odometry.icputils import (
    point_to_plane_ICP,
    point_to_plane_ICP_projective,
    point_to_plane_gradICP,
    point_to_plane_gradICP_projective,
)
from ..ops.masking import compact_masked
from ..structures.maparena import MapState, init_map, map_to_pointclouds
from ..structures.rgbdimages import (
    RGBDImages,
    compute_global_normal_map,
    compute_global_vertex_map,
    compute_normal_map,
    compute_vertex_map,
)
from ..utils.device import resolve_device
from ..utils.profiling import spanned
from . import stepgraph
from .fusionutils import (
    _project_points_to_frame,
    _resolve_assoc_window,
    _resolve_model_rows,
    aggregate_map_dense,
    fusion_update_compact,
)
from .mapshard import MapShard

__all__ = [
    "ICPSLAM",
    "SLAMOptions",
    "SLAMState",
    "slam_step",
    "slam_init_state",
    "slam_step_state",
    "slam_sequence",
    "slam_state_from_numpy",
    "slam_state_to_numpy",
    "candidate_capacity",
]


@dataclass(frozen=True)
class SLAMOptions:
    """Static SLAM configuration; the fields and defaults of the JAX
    package's ``SLAMOptions``.

    ``merge_window`` only shapes the JAX package's TPU layout and is
    accepted and ignored.
    """

    odom: str = "gradicp"  # 'gt' | 'icp' | 'gradicp'
    assoc: str = "knn"  # odometry association: 'knn' | 'projective'
    dsratio: int = 4
    pyramid: Optional[Tuple[int, ...]] = None  # coarse-to-fine dsratios
    numiters: int = 20
    damp: float = 1e-8
    dist_thresh: Optional[float] = None  # odometry gate (squared distance)
    robust_delta: Optional[float] = None  # Huber threshold on ICP residuals
    fusion: bool = False  # False -> aggregate mapping (ICPSLAM)
    dist_th: float = 0.05
    dot_th: float = 0.93969262  # cos 20 deg
    sigma: float = 0.6
    map_capacity: Optional[int] = None  # default: L*H*W
    tgt_capacity: Optional[int] = None  # odometry candidate buffer
    active_capacity: Optional[int] = None  # fusion active set (2*H*W)
    block_size: Optional[int] = None
    visible_capacity: Optional[int] = None
    lambda_max: float = 2.0
    B: float = 1.0
    B2: float = 1.0
    nu: float = 200.0
    reuse_actives: bool = True  # odometry candidates from the fusion step
    merge_window: int = -1
    assoc_window: int = 0  # fusion association prefix rows (<= 0 off)
    odom_targets: str = "map"  # aggregate mapping: 'map' | 'recent'
    model_rows: str = "auto"  # projective targets: 'gather' | 'dense' | 'auto'
    window_merge: str = "dense"  # assoc_window merge: 'dense' | 'rows'


def candidate_capacity(opts: SLAMOptions, H: int, W: int,
                       capacity: Optional[int] = None) -> Tuple[int, Optional[int]]:
    """The fusion step's candidate carry: ``(width, window)``.

    ``width`` is the candidate buffer's, ``active_capacity`` (default
    ``2*H*W``). Given the arena's ``capacity``, ``window`` is the number of
    prefix rows fusion associates against (``assoc_window``; None when it is
    off, with block gating, or without fusion), and a window no larger than
    the buffer is carried uncompacted, so ``width`` is then the window's.
    """
    A = opts.active_capacity or 2 * H * W
    if capacity is None or not opts.fusion or opts.block_size is not None:
        return A, None
    win = _resolve_assoc_window(opts.assoc_window, capacity)
    return (win if win is not None and win <= A else A), win


def _frame_maps_local(depth, intrinsics):
    """Pose-independent maps of a (B, H, W, 1) depth frame:
    (vertex map, normal map, valid mask)."""
    depth5 = depth[:, None]
    vm5 = compute_vertex_map(depth5, intrinsics)
    valid5 = depth5 > 0
    nm5 = compute_normal_map(vm5, valid5)
    return vm5[:, 0], nm5[:, 0], valid5[:, 0, ..., 0]


def _frame_maps(rgb, depth, intrinsics, pose, local_maps=None):
    """Derived maps of a (B, H, W, .) frame at the (B, 4, 4) pose:
    (vm, nm, global vm, global nm, valid)."""
    if local_maps is None:
        local_maps = _frame_maps_local(depth, intrinsics)
    vm, nm, valid = local_maps
    valid5 = valid[:, None, ..., None]
    gv = compute_global_vertex_map(vm[:, None], pose[:, None], valid5)[:, 0]
    gn = compute_global_normal_map(nm[:, None], pose[:, None])[:, 0]
    return vm, nm, gv, gn, valid


def _take_rows(data, idx):
    return torch.gather(data, 1, idx.long()[..., None].expand(-1, -1, data.shape[-1]))


def _odometry_candidates(map_state, cand_slots, cand_valid, app_start, win, shard):
    """Candidate rows for localization at the previous pose: the previous
    fusion step's active set plus the rows it appended, which lie
    contiguously at ``[app_start, num_points)``.

    Under a map ``shard`` each rank writes the rows it holds at their
    positions and one owner-placed sum assembles them: points and normals
    only, the channels the odometry reads.

    Returns:
        (rows (B, A+win, 6); valid (B, A+win) bool).
    """
    CAP = shard.capacity
    win = min(win, CAP)
    start = torch.clamp(app_start, 0, CAP - win)
    slot_n = start[:, None] + torch.arange(win, dtype=torch.int32, device=app_start.device)[None, :]
    valid_n = (slot_n >= app_start[:, None]) & (slot_n < map_state.num_points[:, None])
    valid = torch.cat([cand_valid, valid_n], dim=1)
    return shard.gather_rows(map_state.data[..., 0:6], torch.cat([cand_slots, slot_n], dim=1)), valid


def _default_tgt_capacity(H, W, ds):
    cap = 4 * ((H + ds - 1) // ds) * ((W + ds - 1) // ds)
    return max(1024, ((cap + 1023) // 1024) * 1024)


@spanned("odometry")
def _localize(map_state, prev_pose, rgb, depth, intrinsics, opts: SLAMOptions, cand=None,
              local_maps=None, shard=None):
    """Odometry: the new (B, 4, 4) pose of the live frame.

    The live frame is seeded with the previous pose; the source cloud is
    the strided global vertex map; the targets are the map points active
    in the previous frame that land on the ``ds`` pixel grid. ``cand``
    (optional ``(slots, valid, app_start)``) restricts the projection and
    compaction to the rows carried from the previous fusion step. Without
    it, fusion mapping with ``assoc_window`` takes the targets from the
    arena prefix window, as the fusion association does (in aggregate
    mapping the prefix is append history, so the window is ignored there).

    Without ``cand`` each rank of a map ``shard`` (None: one process)
    projects the rows it holds (of the window, when there is one), the
    targets of each level are the global compaction of their mask
    (:meth:`MapShard.compact`) and their rows an owner-placed gather: every
    rank solves on the same targets.
    """
    B, H, W, _ = rgb.shape
    _, _, gv, _, valid = _frame_maps(rgb, depth, intrinsics, prev_pose, local_maps)
    levels = tuple(opts.pyramid or (opts.dsratio,))
    if shard is None:
        shard = MapShard.whole(map_state.capacity)
    targets = _odometry_targets(map_state, prev_pose, intrinsics, opts, cand, shard, H, W, levels)

    transform = None
    for ds, (rows, tgt_valid) in zip(levels, targets):
        src = gv[:, ::ds, ::ds].reshape(B, -1, 3)
        src_valid = valid[:, ::ds, ::ds].reshape(B, -1).to(src.dtype)
        common = dict(
            numiters=opts.numiters,
            damp=opts.damp,
            dist_thresh=opts.dist_thresh,
            robust_delta=opts.robust_delta,
            src_valid=src_valid,
            tgt_valid=tgt_valid,
        )
        if opts.odom == "gradicp":
            transform = point_to_plane_gradICP(
                src, rows[..., 0:3], rows[..., 3:6], transform,
                lambda_max=opts.lambda_max, B=opts.B, B2=opts.B2, nu=opts.nu, **common,
            )
        else:
            transform = point_to_plane_ICP(src, rows[..., 0:3], rows[..., 3:6], transform, **common)
    return compose_transformations(transform, prev_pose)


@spanned("odometry.targets")
def _odometry_targets(map_state, prev_pose, intrinsics, opts: SLAMOptions, cand, shard, H, W, levels):
    """The odometry targets of each pyramid level: the candidate rows
    (``cand``'s, or the arena window's) projected at the previous pose,
    those on the level's pixel grid compacted into its fixed capacity and
    their rows gathered. Returns [(rows (B, T, 6), valid (B, T)) a level]."""
    if cand is None:
        win = _resolve_assoc_window(opts.assoc_window, shard.capacity) if opts.fusion else None
        src_rows, src_live = shard.window(map_state, win)
    else:
        src_rows, src_live = _odometry_candidates(map_state, *cand, win=H * W, shard=shard)
    h, w, active = _project_points_to_frame(src_rows[..., 0:3], src_live, prev_pose, intrinsics, H, W)
    targets = []
    for ds in levels:
        tc = opts.tgt_capacity or _default_tgt_capacity(H, W, ds)
        on_grid = active & (h % ds == 0) & (w % ds == 0)
        if cand is None:
            _, _, slots, tgt_valid = shard.compact(on_grid, tc)
            targets.append((shard.gather_rows(map_state.data[..., 0:6], slots), tgt_valid))
        else:
            idx, tgt_valid = compact_masked(on_grid, tc)
            targets.append((_take_rows(src_rows, idx), tgt_valid))
    return targets


@spanned("odometry")
def _localize_projective(map_state, prev_pose, model_img, rgb, depth, intrinsics,
                         opts: SLAMOptions, local_maps=None, model_rows=None, shard=None):
    """Odometry by projective association against the model image that the
    previous fusion step made at ``prev_pose``: the (B, H*W, 7) target rows
    are ``model_rows`` when carried, else one gather of the arena at
    ``model_img`` (with a ``shard``, an owner-placed one). The association
    gate defaults to ``dist_th**2`` (squared distances): a projection onto
    an unrelated surface would otherwise give a confidently wrong
    correspondence."""
    B, H, W, _ = rgb.shape
    if shard is None:
        shard = MapShard.whole(map_state.capacity)
    CAP = shard.capacity
    _, _, gv, _, valid = _frame_maps(rgb, depth, intrinsics, prev_pose, local_maps)
    if model_rows is not None:
        tgt_img = model_rows
    else:
        rows = shard.gather_rows(map_state.data[..., 0:6], torch.clamp(model_img, max=CAP - 1))
        tvalid = (model_img < CAP).to(rows.dtype)
        tgt_img = torch.cat([rows[..., 0:6], tvalid[..., None]], dim=-1)
    dist_thresh = opts.dist_thresh if opts.dist_thresh is not None else opts.dist_th**2

    transform = None
    for ds in opts.pyramid or (opts.dsratio,):
        src = gv[:, ::ds, ::ds].reshape(B, -1, 3)
        common = dict(
            numiters=opts.numiters,
            damp=opts.damp,
            dist_thresh=dist_thresh,
            robust_delta=opts.robust_delta,
            src_valid=valid[:, ::ds, ::ds].reshape(B, -1).to(src.dtype),
        )
        if opts.odom == "gradicp":
            transform = point_to_plane_gradICP_projective(
                src, tgt_img, prev_pose, intrinsics, H, W, transform,
                lambda_max=opts.lambda_max, B=opts.B, B2=opts.B2, nu=opts.nu, **common,
            )
        else:
            transform = point_to_plane_ICP_projective(
                src, tgt_img, prev_pose, intrinsics, H, W, transform, **common
            )
    return compose_transformations(transform, prev_pose)


@spanned("mapping")
def _map_update(map_state, pose, rgb, depth, intrinsics, opts: SLAMOptions,
                return_active: bool = False, labels=None, local_maps=None, shard=None):
    """Mapping: fuse (or aggregate) the live frame, and its optional (B, H, W)
    semantic ``labels``, into the arena.

    With ``return_active`` the fusion path also returns
    ``(slots, valid, model_img, model_rows or None)``. With a ``shard``
    ``model_rows='auto'`` resolves on the global capacity, as on one device.
    """
    vm, nm, gv, gn, valid = _frame_maps(rgb, depth, intrinsics, pose, local_maps)
    if opts.fusion:
        H, W = rgb.shape[1:3]
        CAP = map_state.capacity if shard is None else shard.capacity  # the global arena's
        dense = return_active and _resolve_model_rows(opts.model_rows, H, W, CAP)
        ret = fusion_update_compact(
            map_state, gv, gn, vm, rgb, valid, pose, intrinsics,
            opts.dist_th, opts.dot_th, opts.sigma,
            candidate_capacity(opts, H, W)[0],
            opts.block_size, opts.visible_capacity,
            return_active=return_active,
            frame_labels=labels,
            merge_window=opts.merge_window,
            assoc_window=opts.assoc_window,
            dense_model_rows=dense,
            window_merge=opts.window_merge,
            # projective odometry does not reuse the compacted set
            need_active_set=opts.assoc != "projective",
            shard=shard,
        )
        if not return_active:
            return ret
        out, active = ret
        return out, ((*active, None) if len(active) == 3 else active)
    out = aggregate_map_dense(map_state, gv, gn, vm, rgb, valid, opts.sigma, frame_labels=labels, shard=shard)
    return (out, None) if return_active else out


def slam_step(map_state: MapState, prev_pose, rgb, depth, intrinsics, opts: SLAMOptions,
              gt_pose=None):
    """One SLAM step on a bare arena: localize (full-arena candidates),
    then map. Returns ``(new_map_state, pose)``."""
    if opts.odom == "gt":
        if gt_pose is None:
            raise ValueError("gt odometry requires gt_pose")
        pose = gt_pose
    else:
        if opts.assoc == "projective":
            raise ValueError(
                "assoc='projective' needs the carried model image; use "
                "slam_init_state/slam_step_state or slam_sequence"
            )
        if not opts.fusion and opts.odom_targets == "recent":
            raise ValueError(
                "odom_targets='recent' needs the carried append window; use "
                "slam_init_state/slam_step_state or slam_sequence"
            )
        pose = _localize(map_state, prev_pose, rgb, depth, intrinsics, opts)
    return _map_update(map_state, pose, rgb, depth, intrinsics, opts), pose


class SLAMState(NamedTuple):
    """Incremental SLAM state: everything the next frame needs.

    Attributes:
        map_state: the arena.
        pose: (B, 4, 4) last frame's pose.
        cand_slots / cand_valid: (B, A) compacted fusion active set (the
            gated set with ``assoc='projective'``, which does not reuse it).
        app_start: (B,) first arena slot appended by the last frame.
        model_img: (B, H*W) int32 arena slot fused at each pixel (CAP none):
            the target of projective odometry.
        model_rows: None, or the (B, H*W, 7) rows ``[point, normal, valid]``
            at ``model_img`` when ``model_rows`` resolves to dense.
    """

    map_state: MapState
    pose: torch.Tensor
    cand_slots: torch.Tensor
    cand_valid: torch.Tensor
    app_start: torch.Tensor
    model_img: torch.Tensor
    model_rows: Optional[torch.Tensor] = None


@spanned("init_state")
def slam_init_state(rgb, depth, intrinsics, opts: SLAMOptions, capacity: int, pose0=None,
                    labels=None, shard=None) -> SLAMState:
    """Maps the first (B, H, W, .) frame, and its optional (B, H, W)
    semantic ``labels``, into a fresh arena of ``capacity`` rows at
    ``pose0`` (identity when None); with a ``shard``, into this rank's
    ``capacity / n`` rows of it."""
    B, H, W, _ = rgb.shape
    dev, dtype = rgb.device, rgb.dtype
    map_state = init_map(B, capacity if shard is None else shard.rows, dtype, device=dev)
    if pose0 is None:
        pose0 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
    A, _ = candidate_capacity(opts, H, W, capacity)
    app_start = map_state.num_points
    if opts.fusion:
        map_state, (slots, valid, model_img, model_rows) = _map_update(
            map_state, pose0, rgb, depth, intrinsics, opts, return_active=True, labels=labels, shard=shard
        )
    else:
        map_state = _map_update(map_state, pose0, rgb, depth, intrinsics, opts, labels=labels, shard=shard)
        slots = torch.zeros((B, A), dtype=torch.int32, device=dev)
        valid = torch.zeros((B, A), dtype=torch.bool, device=dev)
        model_img = torch.full((B, H * W), capacity, dtype=torch.int32, device=dev)
        model_rows = None
    return SLAMState(map_state, pose0, slots, valid, app_start, model_img, model_rows)


def slam_step_state(state: SLAMState, rgb, depth, intrinsics, opts: SLAMOptions, gt_pose=None,
                    labels=None, local_maps=None, shard=None) -> SLAMState:
    """One SLAM step on a :class:`SLAMState` (the frame-loop body).

    With fusion and ICP odometry, the odometry candidates are the carried
    fusion active set plus the last frame's appends, not the whole arena;
    with ``assoc='projective'`` the target is the carried model image.
    ``labels`` (B, H, W) are the frame's semantic labels. With a ``shard``
    the state's arena is this rank's part (see the module's docstring).
    """
    if opts.odom == "gt":
        if gt_pose is None:
            raise ValueError("gt odometry requires gt_pose")
        pose = gt_pose
    elif opts.assoc == "projective":
        if not opts.fusion:
            raise ValueError(
                "assoc='projective' requires fusion mapping (the model image "
                "comes from the fusion step)"
            )
        pose = _localize_projective(
            state.map_state, state.pose, state.model_img, rgb, depth, intrinsics, opts,
            local_maps=local_maps, model_rows=state.model_rows, shard=shard,
        )
    else:
        cand = None
        if opts.fusion and opts.reuse_actives:
            cand = (state.cand_slots, state.cand_valid, state.app_start)
        elif not opts.fusion and opts.odom_targets == "recent":
            # append-only mapping: the previous frame's appends alone
            empty = state.cand_slots[:, :0]
            cand = (empty, empty.bool(), state.app_start)
        pose = _localize(state.map_state, state.pose, rgb, depth, intrinsics, opts,
                         cand=cand, local_maps=local_maps, shard=shard)
    app_start = state.map_state.num_points
    if opts.fusion:
        m, (slots, valid, model_img, model_rows) = _map_update(
            state.map_state, pose, rgb, depth, intrinsics, opts,
            return_active=True, labels=labels, local_maps=local_maps, shard=shard,
        )
    else:
        m = _map_update(state.map_state, pose, rgb, depth, intrinsics, opts, labels=labels,
                        local_maps=local_maps, shard=shard)
        slots, valid, model_img = state.cand_slots, state.cand_valid, state.model_img
        model_rows = state.model_rows
    return SLAMState(m, pose, slots, valid, app_start, model_img, model_rows)


@spanned("slam_sequence")
def slam_sequence(rgb_seq, depth_seq, intrinsics, poses_seq, opts: SLAMOptions, capacity: int,
                  labels_seq=None, shard=None):
    """Runs SLAM over a whole (B, L, H, W, .) sequence.

    Args:
        rgb_seq: (B, L, H, W, 3); depth_seq: (B, L, H, W, 1).
        intrinsics: (B, 1, 4, 4).
        poses_seq: (B, L, 4, 4) ground-truth / seed poses, or None.
        capacity: arena capacity.
        labels_seq: optional (B, L, H, W) semantic labels, fused into the
            arena's channels 10-11 (``MapState.labels``, ``label_conf``).
        shard: optional :class:`~gradslam_tpu_torch.slam.mapshard.MapShard`:
            every rank of its group calls with the same frames and keeps its
            ``capacity / n`` rows of the arena, on every mapping path.

    Returns:
        (map_state, poses (B, L, 4, 4)); with a ``shard``, the map state is
        this rank's part and the poses are the same on every rank.
    """
    L = rgb_seq.shape[1]
    if opts.odom == "gt" and poses_seq is None:
        raise ValueError("gt odometry requires poses")
    pose0 = None if poses_seq is None else poses_seq[:, 0]
    lab = (lambda t: None) if labels_seq is None else (lambda t: labels_seq[:, t])
    state = slam_init_state(rgb_seq[:, 0], depth_seq[:, 0], intrinsics, opts, capacity, pose0, labels=lab(0),
                            shard=shard)
    gt_seq = poses_seq if opts.odom == "gt" else None
    if L > 1 and stepgraph.eager_reason((rgb_seq, depth_seq, intrinsics, poses_seq, labels_seq), shard) is None:
        graph = stepgraph.sequence_graph(state, rgb_seq, depth_seq, intrinsics, gt_seq, opts, labels_seq, shard)
        last, poses = graph.run(state, rgb_seq, depth_seq, intrinsics, gt_seq, labels_seq, 1, L)
        return last.map_state, torch.cat([state.pose[:, None], poses], dim=1)
    poses = [state.pose]
    for t in range(1, L):
        gt = poses_seq[:, t] if opts.odom == "gt" else None
        state = slam_step_state(state, rgb_seq[:, t], depth_seq[:, t], intrinsics, opts, gt, labels=lab(t),
                                shard=shard)
        poses.append(state.pose)
    return state.map_state, torch.stack(poses, dim=1)


def slam_state_from_numpy(map_data, num_points, pose, cand_slots, cand_valid, app_start,
                          model_img, model_rows=None, device=None) -> SLAMState:
    """A :class:`SLAMState` from the JAX package's ``SLAMState`` fields as
    numpy arrays (``map_state`` given as its ``data`` and ``num_points``)."""
    from ..structures.maparena import map_state_from_numpy

    dev = resolve_device(device)
    i32 = lambda x: torch.tensor(np.asarray(x, dtype=np.int32), device=dev)
    return SLAMState(
        map_state=map_state_from_numpy(map_data, num_points, dev),
        pose=torch.tensor(np.asarray(pose, dtype=np.float32), device=dev),
        cand_slots=i32(cand_slots),
        cand_valid=torch.tensor(np.asarray(cand_valid, dtype=bool), device=dev),
        app_start=i32(app_start),
        model_img=i32(model_img),
        model_rows=None
        if model_rows is None
        else torch.tensor(np.asarray(model_rows, dtype=np.float32), device=dev),
    )


def slam_state_to_numpy(state: SLAMState) -> dict:
    """The inverse of :func:`slam_state_from_numpy`: a dict of its
    keyword arguments as numpy arrays."""
    np_ = lambda x: None if x is None else x.detach().cpu().numpy()
    return dict(
        map_data=np_(state.map_state.data),
        num_points=np_(state.map_state.num_points),
        pose=np_(state.pose),
        cand_slots=np_(state.cand_slots),
        cand_valid=np_(state.cand_valid),
        app_start=np_(state.app_start),
        model_img=np_(state.model_img),
        model_rows=np_(state.model_rows),
    )


_OPTION_FIELDS = {f.name for f in fields(SLAMOptions)}


class ICPSLAM:
    """ICP-SLAM pipeline: aggregate mapping with ICP odometry.

    Example:
        >>> slam = ICPSLAM(odom='gradicp')
        >>> pointclouds, poses = slam(rgbdimages)

    Args:
        odom: 'gt', 'icp' or 'gradicp'.
        dsratio, numiters, damp, dist_thresh, map_capacity, tgt_capacity:
            as in :class:`SLAMOptions`.
        loop_closure: None (off) or 'pose', 'appearance' or 'both': after
            the sequence, detect, ICP-verify and pose-graph-correct loop
            closures on the recovered trajectory
            (:func:`~gradslam_tpu_torch.slam.loopclosure.close_loops_rgbd`;
            appearance detection uses the viewpoint-robust invariant
            descriptor). The map is not re-deformed.
        loop_closure_kwargs: overrides forwarded to it.
        device: where the run happens; default ``"cuda"`` (raises when no
            CUDA device is present; pass ``device="cpu"`` for the CPU).
        **kwargs: further :class:`SLAMOptions` fields.
    """

    _fusion = False

    def __init__(
        self,
        *,
        odom: str = "gradicp",
        dsratio: int = 4,
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        map_capacity: Optional[int] = None,
        tgt_capacity: Optional[int] = None,
        loop_closure: Optional[str] = None,
        loop_closure_kwargs: Optional[dict] = None,
        device=None,
        **kwargs,
    ):
        if odom not in ("gt", "icp", "gradicp"):
            raise ValueError(f"odometry method {odom!r} not in ('gt', 'icp', 'gradicp')")
        if loop_closure not in (None, "pose", "appearance", "both"):
            raise ValueError(f"loop_closure must be None, 'pose', 'appearance' or 'both', got {loop_closure!r}")
        unknown = set(kwargs) - _OPTION_FIELDS
        if unknown:
            raise TypeError(f"unknown SLAM options: {sorted(unknown)}")
        for key, allowed in (
            ("assoc", ("knn", "projective")),
            ("model_rows", ("auto", "dense", "gather")),
            ("window_merge", ("dense", "rows")),
            ("odom_targets", ("map", "recent")),
        ):
            if key in kwargs and kwargs[key] not in allowed:
                raise ValueError(f"{key} {kwargs[key]!r} not in {allowed}")
        if kwargs.get("odom_targets") == "recent" and self._fusion:
            raise ValueError("odom_targets='recent' applies to aggregate mapping (ICPSLAM) only")
        assoc_window = kwargs.get("assoc_window", 0) or 0
        if kwargs.get("assoc") == "projective" and not self._fusion:
            raise ValueError("assoc='projective' requires fusion mapping (PointFusion)")
        if assoc_window > 0 and not self._fusion:
            raise ValueError(
                "assoc_window requires fusion mapping (PointFusion): in aggregate mapping "
                "the arena prefix is append history; use odom_targets='recent' instead"
            )
        if assoc_window > 0 and kwargs.get("block_size") is not None:
            raise ValueError("assoc_window and block_size are mutually exclusive working-set bounds")
        if assoc_window > 0 and (kwargs.get("merge_window", -1) or 0) > 0:
            raise ValueError(
                "an explicit merge_window has no effect with assoc_window: drop "
                "merge_window (or set it to -1 or 0)"
            )
        self.device = resolve_device(device)
        self.odom = odom
        self.loop_closure = loop_closure
        self.loop_closure_kwargs = dict(loop_closure_kwargs or {})
        self.opts = SLAMOptions(
            odom=odom, dsratio=dsratio, numiters=numiters, damp=damp,
            dist_thresh=dist_thresh, fusion=self._fusion, map_capacity=map_capacity,
            tgt_capacity=tgt_capacity, **kwargs,
        )
        self._graphs = stepgraph.GraphCache()  # step's and step_state's captured steps

    def __call__(self, frames: RGBDImages):
        return self.forward(frames)

    def _frames(self, frames: RGBDImages):
        if not isinstance(frames, RGBDImages):
            raise TypeError(f"expected RGBDImages, got {type(frames).__name__}")
        if frames.device != self.device:
            frames = frames.to(self.device)
        return frames.to_channels_last()

    def forward(self, frames: RGBDImages):
        """Runs SLAM over a whole sequence.

        Returns:
            (pointclouds, poses): the map as :class:`Pointclouds` and the
            (B, L, 4, 4) poses.
        """
        rgbd = self._frames(frames)
        B, L, H, W = rgbd.shape
        capacity = self.opts.map_capacity or L * H * W
        map_state, poses = slam_sequence(
            rgbd.rgb_image, rgbd.depth_image, rgbd.intrinsics, rgbd.poses, self.opts, capacity
        )
        if self.loop_closure is not None:
            from .loopclosure import close_loops_rgbd

            poses = close_loops_rgbd(rgbd.rgb_image, rgbd.depth_image, rgbd.intrinsics, poses,
                                     detection=self.loop_closure, **self.loop_closure_kwargs)
        return map_to_pointclouds(map_state), poses

    def step(self, map_state: MapState, live_frame: RGBDImages, prev_pose=None):
        """Localizes and maps one (B, 1) frame on a bare arena.

        Returns:
            (map_state, pose (B, 4, 4)).
        """
        rgbd = self._frames(live_frame)
        rgb, depth = rgbd.rgb_image[:, 0], rgbd.depth_image[:, 0]
        opts = self.opts
        if prev_pose is None or self.odom == "gt":
            if not rgbd.has_poses:
                raise ValueError("live_frame must have poses for the first frame or gt odometry")
            pose = rgbd.poses[:, 0]
            fn = lambda d, n, p, r, dep, k: _map_update(MapState(d, n), p, r, dep, k, opts)
            return self._frame_step("map", fn, (map_state.data, map_state.num_points, pose, rgb, depth,
                                                rgbd.intrinsics)), pose
        fn = lambda d, n, p, r, dep, k: slam_step(MapState(d, n), p, r, dep, k, opts)
        return self._frame_step("slam", fn, (map_state.data, map_state.num_points, prev_pose, rgb, depth,
                                             rgbd.intrinsics))

    def _frame_step(self, name, fn, args):
        """``fn(*args)``: the "map" or "slam" step as its captured graph
        when the graph rules allow (``slam/stepgraph.py``), else eagerly."""
        if stepgraph.eager_reason(args) is not None:
            return fn(*args)
        return self._graphs.get(stepgraph.FrameGraph.key(name, args), lambda: stepgraph.FrameGraph(fn, args))(*args)

    def init_state(self, live_frame: RGBDImages, capacity: Optional[int] = None) -> SLAMState:
        """Starts an incremental run: maps the first frame into a fresh
        arena of ``capacity`` rows (default ``map_capacity`` or 100 frames)."""
        rgbd = self._frames(live_frame)
        B, L, H, W = rgbd.shape
        cap = capacity or self.opts.map_capacity or 100 * H * W
        pose0 = rgbd.poses[:, 0] if rgbd.has_poses else None
        return slam_init_state(
            rgbd.rgb_image[:, 0], rgbd.depth_image[:, 0], rgbd.intrinsics, self.opts, cap, pose0
        )

    @spanned("step_state")
    def step_state(self, state: SLAMState, live_frame: RGBDImages) -> SLAMState:
        """One incremental step on a :class:`SLAMState`.

        On a CUDA device the step is a captured graph
        (``slam/stepgraph.py``) that advances this instance's static carry
        in place, as the JAX package's ``donate_argnums=0`` updates the
        arena: ``state`` is copied into the carry, and the returned state
        is a copy of the new carry that the caller owns (no later step
        overwrites it).
        """
        rgbd = self._frames(live_frame)
        gt = rgbd.poses[:, 0] if self.opts.odom == "gt" and rgbd.has_poses else None
        if self.opts.odom == "gt" and gt is None:
            raise ValueError("gt odometry requires live_frame poses")
        rgb, depth, K = rgbd.rgb_image[:, 0], rgbd.depth_image[:, 0], rgbd.intrinsics
        if stepgraph.eager_reason((rgb, depth, K, gt, *stepgraph.state_tensors(state))) is not None:
            return slam_step_state(state, rgb, depth, K, self.opts, gt)
        args = (self.opts, state, rgb, depth, K, gt)
        graph = self._graphs.get(stepgraph.StepGraph.key(*args), lambda: stepgraph.StepGraph(*args))
        return graph.step_state(state, rgb, depth, K, gt)

    def __repr__(self):
        return f"{type(self).__name__}(odom={self.odom!r}, device={self.device}, opts={self.opts})"
