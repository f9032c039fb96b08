"""In-loop arena lifecycle: watermark-triggered compaction for sequences
that outgrow the fixed-capacity map arena (PyTorch port of
gradslam_tpu.slam.lifecycle).

The static-shape arena (structures/maparena.py) drops appends past
capacity, silently if nothing manages it. This module closes that gap: the
frame loop runs in segments and, between segments, reclaims arena slots when
a capacity watermark is crossed, by voxel-merging near-duplicates or evicting
low-confidence points (the fixed-capacity analogue of PointFusion's
unstable-point removal, Keller et al. 2013 §4.3).

Compaction permutes the arena's slots, so the SLAM state's cached slot
references (the odometry candidates, the projective model image) are
rebuilt afterwards by projecting the compacted arena at the current pose
(:func:`refresh_slam_state`), whose per-pixel nearest point is one
selection of the winner kernel.

On a CUDA device :func:`slam_sequence_managed` runs each segment through the
captured frame step of ``slam/stepgraph.py`` (the JAX package's jitted
``_scan_segment``): compaction changes the arena's contents, not its shapes,
so every segment replays the same graph. :func:`slam_sequence_compacted`
decides nothing on the host, so on a CUDA device its whole run, every
compaction included, is one captured graph (the JAX package's one jitted
scan of scans); under a gradient it runs op by op, and inside a training
step's graph (``stepgraph.GradStep``) it is recorded there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry import inverse_transformation, transform_pointcloud
from ..ops.masking import compact_masked
from ..ops.winner import pixel_winner, winner_keys
from ..structures.maparena import MapState, compact_map, voxel_compact_map
from . import stepgraph
from .fusionutils import _resolve_model_rows, _take, project_map_to_frame
from .icpslam import SLAMOptions, SLAMState, candidate_capacity, slam_init_state, slam_step_state

__all__ = [
    "refresh_slam_state",
    "compact_slam_state",
    "slam_sequence_managed",
    "slam_sequence_compacted",
]

_POLICIES = ("voxel", "evict")


def refresh_slam_state(state: SLAMState, intrinsics, opts: SLAMOptions, H: int, W: int) -> SLAMState:
    """Rebuilds the slot-referencing caches of a :class:`SLAMState` after
    the arena was permuted (compaction, eviction, a loaded checkpoint).

    - ``cand_slots`` / ``cand_valid``: the arena points visible at the
      current pose, compacted into :func:`candidate_capacity` rows; with an
      ``assoc_window``, only the window's rows, as the fusion step carries.
    - ``model_img``: per pixel the visible point of least camera z, the
      least slot among equal z: the occlusion-correct target of
      ``assoc='projective'``. ``CAP`` where no point projects (the JAX
      package writes 2**31 - 1 there; every reader tests ``< CAP``).
    - ``model_rows`` (when carried): the arena rows at ``model_img``.
    - ``app_start``: ``num_points`` (no fresh appends yet).
    """
    m = state.map_state
    B, CAP = m.data.shape[:2]
    HW = H * W
    dev = m.data.device

    h, w, active = project_map_to_frame(m, state.pose, intrinsics, H, W)
    slot = torch.arange(CAP, dtype=torch.int32, device=dev).expand(B, CAP)
    width, win = candidate_capacity(opts, H, W, CAP)
    in_window = active if win is None else active & (slot < win)
    slots, valid = compact_masked(in_window, width)

    z = transform_pointcloud(m.points, inverse_transformation(state.pose))[..., 2]
    pix = torch.where(active, h * W + w, HW)
    # the least z, then the least slot: the winner's key words with the z
    # word where the fusion puts -ccount (its unsigned order is z's) and a
    # constant second word
    k_hi, k_lo = winner_keys(-z, torch.zeros_like(z))
    model_img = pixel_winner(pix, k_hi, k_lo, slot, HW, CAP)
    model_rows = state.model_rows
    if model_rows is not None:
        rows = _take(m.data, torch.clamp(model_img, max=CAP - 1))
        tval = (model_img < CAP).to(rows.dtype)
        model_rows = torch.cat([rows[..., 0:6], tval[..., None]], dim=-1)
    return state._replace(
        cand_slots=slots,
        cand_valid=valid,
        app_start=m.num_points,
        model_img=model_img,
        model_rows=model_rows,
    )


def compact_slam_state(
    state: SLAMState,
    intrinsics,
    opts: SLAMOptions,
    H: int,
    W: int,
    policy: str = "voxel",
    voxel_size: float = 0.02,
    min_ccount: float = 1.0,
    keep_recent: int = 0,
) -> SLAMState:
    """Reclaims arena slots and refreshes the state caches.

    policy='voxel': near-duplicate points (same ``voxel_size`` cell)
    collapse into one confidence-weighted point; no observation is
    discarded. policy='evict': drop points with ccount < ``min_ccount``
    (except the ``keep_recent`` newest), Keller §4.3 unstable-point
    removal.
    """
    if policy == "voxel":
        m = voxel_compact_map(state.map_state, voxel_size)
    elif policy == "evict":
        m = compact_map(state.map_state, min_ccount=min_ccount, keep_recent=keep_recent)
    else:
        raise ValueError(f"policy must be 'voxel' or 'evict', got {policy!r}")
    return refresh_slam_state(state._replace(map_state=m), intrinsics, opts, H, W)


def _run_frames(state: SLAMState, rgb_seq, depth_seq, intrinsics, poses_seq, opts: SLAMOptions,
                has_poses: bool, t0: int, t1: int):
    """Continues the SLAM loop from ``state`` over frames ``[t0, t1)``;
    returns (state, [pose (B, 4, 4) per frame])."""
    poses = []
    for t in range(t0, t1):
        gt = poses_seq[:, t] if opts.odom == "gt" and has_poses else None
        state = slam_step_state(state, rgb_seq[:, t], depth_seq[:, t], intrinsics, opts, gt)
        poses.append(state.pose)
    return state, poses


def _run_segment(state: SLAMState, rgb_seq, depth_seq, intrinsics, poses_seq, opts: SLAMOptions,
                 has_poses: bool, t0: int, t1: int):
    """:func:`_run_frames` through the captured step when the graph rules
    of ``slam/stepgraph.py`` allow (the counterpart of the JAX package's
    jitted ``_scan_segment``); returns a state the caller owns."""
    gt_seq = poses_seq if opts.odom == "gt" and has_poses else None
    if stepgraph.eager_reason((rgb_seq, depth_seq, intrinsics, gt_seq, *stepgraph.state_tensors(state))) is not None:
        return _run_frames(state, rgb_seq, depth_seq, intrinsics, poses_seq, opts, has_poses, t0, t1)
    graph = stepgraph.sequence_graph(state, rgb_seq, depth_seq, intrinsics, gt_seq, opts)
    state, poses = graph.run(state, rgb_seq, depth_seq, intrinsics, gt_seq, None, t0, t1)
    return state, list(poses.unbind(1))


def _check_options(opts: SLAMOptions, poses_seq, what: str):
    if not opts.fusion and opts.odom_targets == "recent" and opts.odom != "gt":
        raise ValueError(
            "odom_targets='recent' depends on append recency, which compaction destroys: use "
            f"odom_targets='map' (or fusion) with {what}"
        )
    if opts.odom == "gt" and poses_seq is None:
        raise ValueError("gt odometry requires poses")


def slam_sequence_compacted(
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    poses_seq: Optional[torch.Tensor],
    opts: SLAMOptions,
    capacity: int,
    segment_len: int = 4,
    policy: str = "voxel",
    voxel_size: float = 0.01,
    min_ccount: float = 1.0,
    keep_recent: int = 0,
) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """The lifecycle without a host decision: compacts the arena at every
    segment boundary, ``segment_len`` frames apart, whatever its fill.

    The frames first run are the remainder ``(L-1) % segment_len`` (or, when
    it is 0, the first whole segment), so the arena is never compacted while
    it holds only the first frame. Nothing waits on the host, and gradients
    flow through every compaction, as through :func:`slam_sequence`.

    Returns:
        (map_state, poses (B, L, 4, 4), peak_live): ``peak_live`` is a 0-d
        int32 tensor, the largest live count reached (growth is monotonic
        between boundaries, so the counts at the boundaries give the peak).
        ``num_points`` saturates at ``capacity``, so a caller should check
        ``peak_live < capacity`` as well as any window bound.
    """
    if segment_len < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")
    if policy not in _POLICIES:
        raise ValueError(f"policy must be 'voxel' or 'evict', got {policy!r}")
    _check_options(opts, poses_seq, "a compacting lifecycle")
    static = (opts, capacity, segment_len, policy, voxel_size, min_ccount, keep_recent)
    run = lambda *args: _compacted(*args, *static)
    args = (rgb_seq, depth_seq, intrinsics, poses_seq)
    if stepgraph.eager_reason(args) is not None:
        return run(*args)
    return stepgraph.run_graph(("slam_sequence_compacted", *static), run, args)


def _compacted(rgb_seq, depth_seq, intrinsics, poses_seq, opts, capacity, segment_len, policy, voxel_size,
               min_ccount, keep_recent):
    """:func:`slam_sequence_compacted`'s run, op by op."""
    B, L, H, W, _ = rgb_seq.shape
    has_poses = poses_seq is not None
    state = slam_init_state(rgb_seq[:, 0], depth_seq[:, 0], intrinsics, opts, capacity,
                            poses_seq[:, 0] if has_poses else None)
    poses = [state.pose]
    rem = (L - 1) % segment_len if segment_len < L else L - 1
    pro = rem if rem else min(segment_len, L - 1)
    state, p = _run_frames(state, rgb_seq, depth_seq, intrinsics, poses_seq, opts, has_poses, 1, 1 + pro)
    poses += p
    peaks = []
    for t in range(1 + pro, L, segment_len):
        peaks.append(state.map_state.num_points.max())
        state = compact_slam_state(state, intrinsics, opts, H, W, policy=policy, voxel_size=voxel_size,
                                   min_ccount=min_ccount, keep_recent=keep_recent)
        state, p = _run_frames(state, rgb_seq, depth_seq, intrinsics, poses_seq, opts, has_poses,
                               t, t + segment_len)
        poses += p
    peaks.append(state.map_state.num_points.max())
    return state.map_state, torch.stack(poses, dim=1), torch.stack(peaks).max()


def _close_so_far(poses, pts, nrm, val, detection, **kwargs):
    """The managed run's closure of the frames so far: their descriptors
    (for appearance detection) and ``close_loops_batched``; returns (refined
    poses, loop weights)."""
    from .loopclosure import close_loops_batched, keyframe_descriptors_invariant

    descs = keyframe_descriptors_invariant(pts, nrm, val) if detection in ("appearance", "both") else None
    refined, _, w = close_loops_batched(poses, pts, nrm, val, detection=detection, descriptors=descs, **kwargs)
    return refined, w


def slam_sequence_managed(
    rgb_seq: torch.Tensor,
    depth_seq: torch.Tensor,
    intrinsics: torch.Tensor,
    poses_seq: Optional[torch.Tensor],
    opts: SLAMOptions,
    capacity: int,
    watermark: float = 0.9,
    segment_len: int = 8,
    policy: str = "voxel",
    voxel_size: float = 0.02,
    min_ccount: float = 1.0,
    keep_recent: int = 0,
    loop_closure: Optional[str] = None,
    loop_closure_kwargs: Optional[dict] = None,
    resume_from: Optional[Tuple[MapState, torch.Tensor]] = None,
) -> Tuple[MapState, torch.Tensor]:
    """:func:`slam_sequence` with in-loop arena lifecycle management.

    Runs the frames in segments of ``segment_len``; before each segment, if
    any batch entry's live count exceeds ``watermark * capacity``, the arena
    is compacted (``policy``) and the state caches refreshed, so a long run
    degrades gracefully (bounded density and confidence loss) instead of
    dropping every append past capacity. One scalar host sync per segment.

    With ``resume_from = (map_state, pose)``, e.g. from
    :func:`gradslam_tpu_torch.utils.load_slam_state` (a checkpoint of either
    package), the run continues from that state: every frame of ``rgb_seq``
    is a continuation frame, and the caches are rebuilt from the arena by
    :func:`refresh_slam_state` first. A checkpoint taken at a boundary where
    the uninterrupted run compacts resumes to the bitwise identical state.

    With ``loop_closure`` set ('pose', 'appearance' or 'both'), detection,
    verification and pose-graph correction
    (:func:`~gradslam_tpu_torch.slam.loopclosure.close_loops_batched`, every
    batch entry in one call) run at every segment boundary but the last,
    where the host sync already is, over the trajectory so far, and once
    more over the whole trajectory at the end.
    When a loop edge is accepted at a boundary, the past trajectory is
    refined AND the live tracking pose jumps to its corrected value (the
    caches are rebuilt at the new pose by :func:`refresh_slam_state`, one
    more winner selection), so drift is removed during the run. The fused
    map is not re-deformed. Appearance detection uses
    :func:`~gradslam_tpu_torch.slam.loopclosure.keyframe_descriptors_invariant`;
    the per-keyframe clouds are computed once for the whole sequence.
    ``loop_closure_kwargs`` forwards thresholds (``max_candidates``,
    ``min_separation``, ``max_descriptor_dist``, ``min_inlier_frac``,
    ``dsratio``, ...). After a resume the closure starts from the resume
    point.

    Returns:
        (map_state, poses (B, L, 4, 4)) over the frames of ``rgb_seq``.
    """
    if not 0.0 < watermark <= 1.0:
        raise ValueError(f"watermark must be in (0, 1], got {watermark}")
    if segment_len < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")
    if loop_closure not in (None, "pose", "appearance", "both"):
        raise ValueError(f"loop_closure must be None, 'pose', 'appearance' or 'both', got {loop_closure!r}")
    _check_options(opts, poses_seq, "the managed lifecycle")
    B, L, H, W, _ = rgb_seq.shape
    has_poses = poses_seq is not None

    lc_kwargs = dict(loop_closure_kwargs or {})
    lc_dsratio = lc_kwargs.pop("dsratio", opts.dsratio or 4)
    if loop_closure is not None:
        from .loopclosure import frame_clouds_from_rgbd

        # pose-independent camera-frame clouds of the whole sequence, once
        lc_pts, lc_nrm, lc_val, _, _ = frame_clouds_from_rgbd(depth_seq, intrinsics, lc_dsratio)

    def close_loops_so_far(poses_btl):
        """Every batch entry's trajectory so far closed in one batched call,
        on a CUDA device one captured graph a length (``stepgraph.graphed``):
        (refined poses, whether any loop edge was accepted, read on the host
        after the call)."""
        t_now = poses_btl.shape[1]
        refined, w = stepgraph.graphed(
            "slam_sequence_managed closure", _close_so_far,
            (poses_btl, lc_pts[:, :t_now], lc_nrm[:, :t_now], lc_val[:, :t_now]), detection=loop_closure, **lc_kwargs)
        return refined, bool((w > 0).any())

    if resume_from is not None:
        m0, pose0 = resume_from
        if m0.capacity != capacity:
            raise ValueError(f"resume_from arena capacity {m0.capacity} != requested capacity {capacity}")
        dev = m0.data.device
        dense = opts.fusion and _resolve_model_rows(opts.model_rows, H, W, capacity)
        state = refresh_slam_state(
            SLAMState(
                map_state=m0,
                pose=torch.as_tensor(pose0, dtype=m0.data.dtype, device=dev),
                # the refresh sizes and fills the candidates
                cand_slots=torch.zeros((B, 0), dtype=torch.int32, device=dev),
                cand_valid=torch.zeros((B, 0), dtype=torch.bool, device=dev),
                app_start=m0.num_points,
                model_img=torch.full((B, H * W), capacity, dtype=torch.int32, device=dev),
                model_rows=m0.data.new_zeros((B, H * W, 7)) if dense else None,
            ),
            intrinsics, opts, H, W,
        )
        poses, t = [], 0
    else:
        state = slam_init_state(rgb_seq[:, 0], depth_seq[:, 0], intrinsics, opts, capacity,
                                poses_seq[:, 0] if has_poses else None)
        poses, t = [state.pose], 1
    while t < L:
        if float(state.map_state.num_points.max()) > watermark * capacity:
            state = compact_slam_state(state, intrinsics, opts, H, W, policy=policy, voxel_size=voxel_size,
                                       min_ccount=min_ccount, keep_recent=keep_recent)
        end = min(t + segment_len, L)
        state, p = _run_segment(state, rgb_seq, depth_seq, intrinsics, poses_seq, opts, has_poses, t, end)
        poses += p
        t = end
        # in-loop closure at the boundary (not the last: the whole
        # trajectory is closed below and no tracking is left to correct)
        if loop_closure is not None and 2 < t < L:
            refined, hit = close_loops_so_far(torch.stack(poses, dim=1))
            if hit:
                poses = list(refined.unbind(1))
                state = refresh_slam_state(state._replace(pose=refined[:, -1]), intrinsics, opts, H, W)
    poses = torch.stack(poses, dim=1)
    if loop_closure is not None and L > 2:
        refined, hit = close_loops_so_far(poses)
        if hit:
            poses = refined
    return state.map_state, poses
