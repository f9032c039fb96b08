"""Smoke run of gradslam_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``gradslam_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card, then drives the port's paths through its
public API: ``PointFusion()`` (gradICP odometry, KNN association, exact
full-arena fusion) and ``PointFusion(assoc='projective', assoc_window=...)``
(projective association, capacity-windowed fusion):

  1. the card's name and power limit, and the kernel build;
  2. the KNN kernel against the plain version and a float64 oracle at the
     main path's shapes, both with 30% of the targets invalid and scattered
     and in the main path's layout (the valid targets a prefix), on the
     main path's own inputs (captured from PointFusion runs, which also
     check that layout), and at edge cases (no valid target, ties, an empty
     batch entry, ragged sizes, T=200,000), with its time at the main
     path's shapes, the plain version's, ``torch.cdist``'s as a yardstick,
     and its bound;
  3. the golden clip (B=2, L=10, 120x160) against the reference goldens;
  4. the ScanNet geometry (B=2, L=16, 240x320, a 1.23M-row arena);
  5. the per-pixel winner kernel against its plain version at the diag's
     and the fusion paths' shapes, at 480x640, at edge cases (crafted ties,
     every candidate dumped or on one pixel, pixels out of range, a ragged
     P, three batch entries, slots near 2^31), and on the main path's own
     inputs (every selection of a run of each of the four paths below),
     with its time, the plain version's, ``scatter_reduce_``'s as a
     yardstick and its bound (the design's own bytes and the blocks it
     took in the log);
  6. projective PointFusion on the golden clip (window 2*H*W) against the
     clip's poses;
  7. projective PointFusion at the ScanNet geometry (window 3*H*W, active
     buffer 1.5*H*W, dense model rows) against the clip's poses;
  8. the gradient of ``slam_loss`` (the depth-calibration loss through
     ``PointFusion()``'s whole run) with respect to the calibration
     parameters and the depth maps, on the card against the CPU (golden
     clip, L=3);
  9. the depth-calibration loop of ``examples/train_depth_calib.py`` at
     full width (golden clip, B=2, L=3, 30 steps): the scale found;
 10. one forward and backward of ``slam_loss`` at the ScanNet geometry;
 11. the metrics on the card: ATE and RPE against the CPU, and chamfer
     distance and map accuracy between the maps of a gradICP run and a
     ground-truth-odometry run, with the KNN kernel at those shapes (whole
     arenas as sources, the other arena's live prefix as targets) against
     its plain version, timed, with its bound;
 12. block-gated PointFusion (``block_size=4096``, 300 blocks, 75 visible
     at most) at the ScanNet geometry: its poses against phase 4's ungated
     run, every winner selection against the plain version, the visible
     blocks per frame, and frames/s beside the ungated run's (medians of 3);
 13. semantic labels at the ScanNet geometry on the exact KNN path and the
     projective path: a constant label and 20 random classes, each run
     bit-identical in poses and map channels 0-9 to the run without labels;
 14. the object-level API: the three odometry providers on the golden
     clip's frames 0 -> 1 against the CPU, with every KNN call against the
     plain version; the GradICP provider recovering a known motion of a
     whole 240x320 frame; ``update_map_fusion`` and
     ``find_correspondences`` over the golden clip's first three frames
     against the CPU, with every winner selection against the plain
     version;
 15. files to ATE at the sensor's size: 32 rendered 480x640 frames written
     as a TUM tree (stdlib PNG writer), read by ``TUM(seqlen=16)`` and
     ``DataLoader(batch_size=2, num_workers=4, to_device=card)`` (the
     decode route printed), mapped by ``slam_sequence_managed`` (gradICP,
     an arena of 1.25*H*W rows, watermark 0.9 read after every frame,
     2 cm voxel merges), ATE below 5e-3 m; at least two compactions, each
     reclaiming at least half the live rows, and the arena never above 95%
     full; the voxel merge's cells on the card bit-equal to the CPU's at 2
     and 1 cm; a checkpoint at a compacting boundary resumed from its file
     bitwise equal to the uninterrupted run; the map as PLY; every
     selection (the refresh's too) and a dozen KNN calls against the plain
     version, timed;
 16. the managed run at the ScanNet geometry (L=32, an arena of 2*H*W
     rows, 2 mm voxels) against the unmanaged run: translations within
     5e-3 m, at least one compaction, its cells bit-equal to the CPU's,
     the voxel merge's time;
 17. the gradient of the pose loss through ``slam_sequence_compacted``
     (golden clip, L=6, 5 mm voxels, compaction every 2 frames) on the
     card against the CPU.

Each path runs with every kernel's launch count set to 0 just before it and
read just after: the KNN kernel 40 times per frame step on the KNN path and
never on the projective one, the winner kernel once per fusion step on
both and once per compaction (the refresh's selection), neither in a
backward. Any failed check raises. The line before the
last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": ...}``. Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

# one H100 SXM (NVIDIA data sheet): HBM rate, and the float32 rate outside
# the tensor cores. The sheet's 67 TFLOP/s counts a fused multiply-add as
# two operations; the KNN kernel is built without FMA contraction and issues
# one sub, mul or add per instruction, so its peak is half that.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
KNN_OPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per (source, valid target) pair
# SM clock cycles per second at the H100's 1.98 GHz boost: a sleep of this
# many cycles lasts at least a second
SLEEP_CYCLES_PER_S = 2_000_000_000
INT64_MAX = 2**63 - 1
INT32_MIN = -(2**31)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time per call from CUDA events around ``reps`` calls.

    The calls queue behind a sleep kernel that outlasts their dispatch on
    the host, so the device runs them back to back and the events measure
    the device's time, not the host's (a small kernel's wrapper takes
    longer to call than the kernel takes to run).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    queue_s = min(2.0, 2 * reps * (time.perf_counter() - t0) + 0.01)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(queue_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# 2. KNN kernel against its plain version
# ---------------------------------------------------------------------------


def _knn_oracle(src, tgt, valid, chunk=256):
    """Nearest squared distance per source, float64 numpy difference form."""
    s = src.double().cpu().numpy()
    t = tgt.double().cpu().numpy()
    inval = ~valid.cpu().numpy()[:, None, :]
    out = []
    for s0 in range(0, s.shape[1], chunk):
        d = ((s[:, s0 : s0 + chunk, None, :] - t[:, None, :, :]) ** 2).sum(-1)
        out.append(np.where(inval, np.inf, d).min(-1))
    return np.concatenate(out, axis=1)


def _knn_case(name, src, tgt, valid, oracle=True):
    from gradslam_tpu_torch.ops.knn import knn_kernel, knn_reference, prepare_targets

    prep = prepare_targets(tgt, valid)
    d_k, i_k = knn_kernel(src, prep.packed, prep.limit)
    d_p, i_p = knn_reference(src, tgt, valid)
    torch.cuda.synchronize()
    _check(torch.equal(i_k, i_p), f"knn {name}: indices differ from the plain version")
    _check(torch.equal(d_k, d_p), f"knn {name}: distances differ from the plain version")
    err_oracle = None
    if oracle:
        ref = _knn_oracle(src, tgt, valid)
        dk = d_k.double().cpu().numpy()
        fin = np.isfinite(ref)
        _check(np.array_equal(fin, np.isfinite(dk)), f"knn {name}: inf pattern differs")
        err_oracle = float(np.abs(dk[fin] - ref[fin]).max()) if fin.any() else 0.0
        _check(err_oracle <= 1e-4, f"knn {name}: {err_oracle} from the float64 oracle")
    err_plain = float((d_k - d_p).abs().nan_to_num(0.0).max())
    _log(f"knn {name}: src {tuple(src.shape)} tgt {tuple(tgt.shape)} limit "
         f"{prep.limit.tolist()}: indices equal, max |d - plain| {err_plain}, "
         f"max |d - float64 oracle| {err_oracle}")
    return d_k, i_k, err_plain


def _main_path_knn_inputs(colors, depths, K, dev, every=40):
    """The (src, tgt, valid) of every ``every``-th KNN call of a
    ``PointFusion()`` run, as ``_localize`` builds them (the first call of
    each frame step by default), and each call's valid count and limit."""
    from gradslam_tpu_torch import PointFusion, RGBDImages
    from gradslam_tpu_torch.odometry import icputils

    calls, counts = [], []
    real_knn = icputils.knn

    def recording_knn(src, tgt, tgt_valid=None):
        counts.append((int(tgt.valid.sum()), int(tgt.limit.sum()), tgt.num_targets, tgt.limit.shape[0]))
        if (len(counts) - 1) % every == 0:
            calls.append((src.detach().clone(), tgt.tgt.clone(), tgt.valid.clone()))
        return real_knn(src, tgt, tgt_valid)

    icputils.knn = recording_knn
    try:
        PointFusion(device=dev)(RGBDImages(colors, depths, K, device=dev))
    finally:
        icputils.knn = real_knn
    return calls, counts


def _knn_bound(src, limit_sum, valid_sum):
    """(bound ms, 'bytes' or 'operations'): each source against the valid
    targets of its own batch entry, 8 float32 operations a pair; the bytes
    are the sources, the targets below each limit and the outputs."""
    B, S, _ = src.shape
    nbytes = B * S * 3 * 4 + limit_sum * 4 * 4 + B * S * (4 + 4)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = S * valid_sum * KNN_OPS_PER_PAIR / FP32_OPS_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s > ops_s else "operations"


CDIST_CHUNK_BYTES = 2**31  # the (B, chunk, T) distances of one cdist call


def _library_knn(src, tgt, valid):
    """``torch.cdist`` (masked, + min), in chunks of sources where the whole
    (B, S, T) distance matrix would pass CDIST_CHUNK_BYTES (at the 480x640
    main path's 2.9e9 pairs one call raises an invalid launch
    configuration)."""
    B, S, _ = src.shape
    chunk = max(1, CDIST_CHUNK_BYTES // (B * tgt.shape[1] * 4))
    out = [torch.cdist(src[:, s0 : s0 + chunk], tgt, compute_mode="donot_use_mm_for_euclid_dist")
           .masked_fill_(~valid[:, None, :], torch.inf).min(-1) for s0 in range(0, S, chunk)]
    return torch.cat([d for d, _ in out], 1), torch.cat([i for _, i in out], 1)


def _time_knn_call(name, src, tgt, valid):
    """Kernel, plain and ``torch.cdist`` (masked, + min; chunked over the
    sources where it must be) times and the bound of one KNN call."""
    from gradslam_tpu_torch.ops.knn import knn_kernel, knn_reference, prepare_targets

    prep = prepare_targets(tgt, valid)
    ms = _time_ms(lambda: knn_kernel(src, prep.packed, prep.limit), reps=50)
    plain_ms = _time_ms(lambda: knn_reference(src, tgt, valid), reps=5, warmup=1)
    B, S, _ = src.shape
    chunks = -(-S // max(1, CDIST_CHUNK_BYTES // (B * tgt.shape[1] * 4)))
    library_ms = _time_ms(lambda: _library_knn(src, tgt, valid), reps=2 if chunks > 1 else 10, warmup=1)
    bound_ms, bound_by = _knn_bound(src, int(prep.limit.sum()), int(valid.sum()))
    _log(f"knn timing {name} B={B} S={S} T={tgt.shape[1]} limit {prep.limit.tolist()}: kernel {ms:.6f} ms, plain "
         f"{plain_ms:.6f} ms, cdist {library_ms:.6f} ms in {chunks} chunks, bound {bound_ms:.6f} ms ({bound_by}), "
         f"tiles {knn_kernel.tiles(B, S, tgt.shape[1])}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def knn_phase(dev):
    """Kernel vs plain version at the main path's shapes and layouts, on the
    main path's own inputs, and at edge cases; returns the kernel's JSON
    entry (without ``launches``)."""
    gen = np.random.default_rng(0)

    def cloud(B, N):
        return torch.from_numpy(gen.uniform(-2, 2, (B, N, 3)).astype(np.float32)).to(dev)

    def validity(B, T, frac):
        return torch.from_numpy(gen.random((B, T)) >= frac).to(dev)

    def prefix(B, T, counts):
        return torch.arange(T, device=dev)[None, :] < torch.tensor(counts, device=dev)[:, None]

    errs = []
    timed = {}
    # the main path's shapes: 30% of targets invalid and scattered (PR 1's
    # cases), and the main path's layout, a valid prefix of the mean count
    # measured on that path (1,776 of 5,120 golden, 6,229 of 19,456 ScanNet)
    for name, B, S, T, n_valid in (("golden", 2, 1200, 5120, 1776), ("scannet", 2, 4800, 19456, 6229)):
        src, tgt = cloud(B, S), cloud(B, T)
        for layout, val in (("30% invalid", validity(B, T, 0.3)), (f"prefix {n_valid}", prefix(B, T, [n_valid] * B))):
            case = f"{name} B={B} S={S} T={T} {layout}"
            errs.append(_knn_case(case, src, tgt, val)[2])
            timed[case] = (src, tgt, val)
    src, tgt = cloud(2, 321), cloud(2, 777)
    errs.append(_knn_case("unpadded 321x777", src, tgt, validity(2, 777, 0.0))[2])
    d, i, _ = _knn_case("all invalid", src, tgt, validity(2, 777, 1.01), oracle=False)
    _check(bool(torch.isinf(d).all()) and int(i.abs().max()) == 0, "knn all invalid: not (inf, 0)")
    # ties: every target twice, so each source has two nearest at equal distance
    tgt_dup = torch.cat([tgt, tgt], dim=1)
    d, i, _ = _knn_case("duplicate-target ties", src, tgt_dup, validity(2, 2 * 777, 0.0))
    _check(int(i.max()) < 777, "knn ties: a duplicate's higher index won")
    # ties between runs of one warp's part: 8 points repeated along T, so
    # every run of 8 targets is the same; the first run must keep the tie
    for T in (256, 5120):
        d, i, _ = _knn_case(f"repeated runs T={T}", cloud(2, 300), cloud(2, 8).repeat(1, T // 8, 1),
                            validity(2, T, 0.0))
        _check(int(i.max()) < 8, "knn repeated runs: a later run kept a tie")
    src, tgt = cloud(2, 1200), cloud(2, 5120)
    d, i, _ = _knn_case("limit 0 beside a full entry", src, tgt, prefix(2, 5120, [5120, 0]))
    _check(bool(torch.isinf(d[1]).all()) and int(i[1].abs().max()) == 0, "knn limit 0: not (inf, 0)")
    for name, B, S, T in (("ragged", 3, 1000, 1000), ("T=1", 3, 77, 1), ("S=1", 3, 1, 5000)):
        errs.append(_knn_case(f"{name} B={B} S={S} T={T}", cloud(B, S), cloud(B, T), validity(B, T, 0.3))[2])
    errs.append(_knn_case("large T B=2 S=1200 T=200000", cloud(2, 1200), cloud(2, 200_000),
                          validity(2, 200_000, 0.3), oracle=False)[2])
    # the main path's own inputs: the first KNN call of each frame step of
    # PointFusion() on the golden clip and at the ScanNet geometry
    for name, clip in (("golden", _golden_clip(10)), ("scannet", _scannet_clip(4))):
        calls, counts = _main_path_knn_inputs(*clip, dev)
        c = np.array(counts, dtype=np.float64)
        _check(bool((c[:, 0] == c[:, 1]).all()), f"knn {name} main path: the valid targets are not a prefix")
        _log(f"knn {name} main path: {len(counts)} calls, valid targets a prefix in every call, "
             f"mean {c[:, 0].mean() / c[0, 3]:.1f} valid of T={int(c[0, 2])} a batch entry "
             f"({c[:, 0].sum() / (c[:, 2] * c[:, 3]).sum():.4f}), range "
             f"{int(c[:, 0].min())}-{int(c[:, 0].max())} a call")
        for n, (src, tgt, val) in enumerate(calls):
            errs.append(_knn_case(f"{name} main path, frame step {n + 1}", src, tgt, val)[2])

    # timing at the main path's shapes and layouts
    timings = {case: _time_knn_call(case, *args) for case, args in timed.items()}
    main = "scannet B=2 S=4800 T=19456 prefix 6229"
    entry = dict(
        name="knn",
        route="cuda",
        source="gradslam_tpu_torch/csrc/knn.cu",
        replaces="gradslam_tpu/ops/knn.py:75",
        max_abs_err=max(errs),
        **timings[main],
        shape=main + " (the main path's layout)",
        other_shapes={case: t for case, t in timings.items() if case != main},
    )
    return entry


# ---------------------------------------------------------------------------
# 3./4. the main path
# ---------------------------------------------------------------------------


def _golden_clip(L):
    d = DATA / "msrd_b2s3"
    colors = np.load(d / "colors.npy")
    depths = np.load(d / "depths.npy")
    idx = [i % colors.shape[1] for i in range(L)]
    return (
        colors[:, idx].astype(np.float32),
        depths[:, idx].astype(np.float32),
        np.load(d / "intrinsics.npy").astype(np.float32),
    )


def _bilinear2x(x):
    """Edge-aligned 2x bilinear upsample over axes (2, 3) of (B, L, H, W, C):
    ``out[2i] = in[i]``, ``out[2i+1] = (in[i] + in[i+1]) / 2``."""
    B, L, H, W, C = x.shape
    xr = x.reshape(B * L, H, W, C)
    rows = np.empty((B * L, 2 * H, W, C), xr.dtype)
    rows[:, 0::2] = xr
    rows[:, 1:-1:2] = 0.5 * (xr[:, :-1] + xr[:, 1:])
    rows[:, -1] = xr[:, -1]
    out = np.empty((B * L, 2 * H, 2 * W, C), xr.dtype)
    out[:, :, 0::2] = rows
    out[:, :, 1:-1:2] = 0.5 * (rows[:, :, :-1] + rows[:, :, 1:])
    out[:, :, -1] = rows[:, :, -1]
    return out.reshape(B, L, 2 * H, 2 * W, C)


def _kernels():
    from gradslam_tpu_torch.ops import knn_kernel, winner_kernel

    return {"knn": knn_kernel, "winner": winner_kernel}


def _launches():
    return {name: k.launches for name, k in _kernels().items()}


def _reset_launches():
    for k in _kernels().values():
        k.launches = 0


def _run_pointfusion(colors, depths, K, dev, **options):
    """``PointFusion(**options)(RGBDImages(...))`` timed by the host clock
    around a synchronized run, with every kernel's launch count set to 0
    just before it; returns (pointclouds, poses, seconds, {kernel:
    launches})."""
    from gradslam_tpu_torch import PointFusion, RGBDImages

    rgbd = RGBDImages(colors, depths, K, device=dev)
    slam = PointFusion(device=dev, **options)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    pcs, poses = slam(rgbd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return pcs, poses, seconds, _launches()


def _check_launches(phase, launches, expected):
    _check(launches == expected, f"{phase}: kernel launches {launches}, expected {expected}")


def _scannet_clip(L):
    """The golden clip, cycled to L, upsampled 2x to 240x320 (intrinsics
    scaled with it): the repo's ScanNet geometry."""
    colors, depths, K = _golden_clip(L)
    K = K.copy()
    K[:, :, :2] *= 2.0  # fx, fy, cx, cy scale with the upsample
    return _bilinear2x(colors), _bilinear2x(depths), K


def _cycled_poses(L):
    gt = np.load(DATA / "msrd_b2s3" / "poses.npy").astype(np.float32)
    return gt[:, [i % gt.shape[1] for i in range(L)]]


def _pose_errors(poses, gt):
    """(max translation error in m, max rotation error in degrees)."""
    terr = np.linalg.norm(poses[..., :3, 3] - gt[..., :3, 3], axis=-1)
    cos = (np.einsum("blij,blij->bl", poses[..., :3, :3], gt[..., :3, :3]) - 1.0) / 2.0
    return float(terr.max()), float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max())


def golden_phase(dev):
    """PointFusion gradicp on the golden clip against the reference goldens."""
    B, L, H, W = 2, 10, 120, 160
    colors, depths, K = _golden_clip(L)
    _run_pointfusion(colors[:, :2], depths[:, :2], K, dev)  # warm-up: load the kernels
    pcs, poses, seconds, launches = _run_pointfusion(colors, depths, K, dev)
    g = np.load(DATA / "reference_goldens" / "pointfusion_gradicp.npz")
    p = poses.cpu().numpy()
    npts = pcs.num_points_per_pointcloud.cpu().numpy()
    pose_err = float(np.abs(p - g["poses"]).max())
    _log(f"golden B={B} L={L} {H}x{W}: {B * L / seconds:.3f} frames/s ({seconds:.3f} s), "
         f"max |pose - golden| {pose_err}, num_points {npts.tolist()} vs golden "
         f"{g['num_points'].tolist()}, launches {launches}")
    _check(pose_err < 2e-3, f"golden poses off by {pose_err}")
    _check(bool(np.all(np.abs(npts - g["num_points"]) <= 0.05 * g["num_points"])),
           f"golden num_points {npts} vs {g['num_points']}")
    _check_launches("golden", launches, {"knn": (L - 1) * 40, "winner": L})
    return p, launches


def scannet_phase(dev, golden_poses):
    """PointFusion gradicp at the repo's ScanNet geometry (240x320, L=16);
    returns (launches, poses, num_points)."""
    B, L, H, W = 2, 16, 240, 320
    colors, depths, K = _scannet_clip(L)
    torch.cuda.reset_peak_memory_stats()
    pcs, poses, seconds, launches = _run_pointfusion(colors, depths, K, dev)
    p = poses.cpu().numpy()
    npts = pcs.num_points_per_pointcloud.cpu().numpy()
    n_gold = golden_poses.shape[1]
    drift = float(np.abs(p[:, :n_gold] - golden_poses).max())
    _log(f"scannet B={B} L={L} {H}x{W} CAP={L * H * W}: {B * L / seconds:.3f} frames/s "
         f"({seconds:.3f} s), peak memory {torch.cuda.max_memory_allocated()} bytes, "
         f"num_points {npts.tolist()}, max |pose - golden-clip pose| {drift}, "
         f"launches {launches}")
    _check(bool(np.isfinite(p).all()), "scannet poses are not finite")
    _check_launches("scannet", launches, {"knn": (L - 1) * 40, "winner": L})
    return launches, p, npts


# ---------------------------------------------------------------------------
# 5. the per-pixel winner kernel against its plain version
# ---------------------------------------------------------------------------

# (name, B, N candidates, P pixels, sentinel): the diag's shapes, which are
# also the exact fusion path's at the ScanNet geometry (N = A = 2*H*W), and
# the other shapes the fusion paths give the kernel
WINNER_SHAPES = (
    ("exact golden", 2, 38_400, 19_200, 10 * 19_200),
    ("exact scannet (diag shapes)", 2, 153_600, 76_800, 16 * 76_800),
    ("projective golden (uncompacted view)", 2, 38_400, 19_200, 10 * 19_200),
    ("projective scannet (gated buffer)", 2, 115_200, 76_800, 16 * 76_800),
)


def _library_winner(pix, k_hi, k_lo, slot, P, sentinel):
    """The yardstick: the same function from ``scatter_reduce_``, two
    rounds of an int64 ``amin`` with a gather-back between them (the
    96-bit key does not fit one word). Never called by the port."""
    p = torch.where((pix >= 0) & (pix < P), pix, P).long()
    key = ((k_hi ^ INT32_MIN).long() << 32) | (k_lo.long() & 0xFFFFFFFF)
    best = torch.full((pix.shape[0], P + 1), INT64_MAX, dtype=torch.int64, device=pix.device)
    best.scatter_reduce_(1, p, key, reduce="amin")
    tie = key == best.gather(1, p)
    out = torch.full((pix.shape[0], P + 1), sentinel, dtype=torch.int32, device=pix.device)
    out.scatter_reduce_(1, torch.where(tie, p, P), slot, reduce="amin")
    return out[:, :P]


def _library_rmw(pix, key, slot, P, sentinel):
    """The yardstick of the ``pallas_rmw`` contract (keys in [0, 2^31),
    pixels in range): one ``scatter_reduce_`` of ``key << 32 | slot``."""
    best = torch.full((pix.shape[0], P), INT64_MAX, dtype=torch.int64, device=pix.device)
    best.scatter_reduce_(1, pix.long(), (key.long() << 32) | slot.long(), reduce="amin")
    return torch.where(best == INT64_MAX, sentinel, best & 0xFFFFFFFF).to(torch.int32)


def _fusion_candidates(gen, B, N, P, CAP, dev, variant):
    """Candidates as a fusion step gives them: a fifth dumped (pix = P, not
    gated), distinct arena slots, and ties crafted per ``variant``."""
    from gradslam_tpu_torch.ops import winner_keys

    pix = gen.integers(0, P, (B, N)).astype(np.int32)
    pix[gen.random((B, N)) < 0.2] = P
    cc = gen.uniform(0.01, 30.0, (B, N)).astype(np.float32)
    ray = gen.uniform(0.0, 0.0025, (B, N)).astype(np.float32)
    if variant in ("ccount ties", "both ties"):
        cc = gen.choice(np.array([0.5, 1.0, 1.5], np.float32), (B, N))
    if variant in ("ray ties", "both ties"):
        ray = gen.choice(np.array([0.0, 1e-4, 2e-4], np.float32), (B, N))
    if variant == "+-0.0":
        cc = gen.choice(np.array([0.0, -0.0, 1.0], np.float32), (B, N))
        ray = gen.choice(np.array([0.0, -0.0, 1e-4], np.float32), (B, N))
    slot = np.stack([gen.choice(CAP, N, replace=False) for _ in range(B)]).astype(np.int32)
    k_hi, k_lo = winner_keys(torch.from_numpy(cc).to(dev), torch.from_numpy(ray).to(dev))
    return torch.from_numpy(pix).to(dev), k_hi, k_lo, torch.from_numpy(slot).to(dev)


def _rmw_inputs(dev):
    """The ``pallas_rmw`` contract at the diag's shapes: random pixels and
    keys in [0, 2^20), ``k_lo = 0``, ``slot = row``, ``sentinel = N``;
    returns (args, P, sentinel)."""
    B, A, HW = 2, 153_600, 76_800
    rng = np.random.default_rng(0)
    pix = torch.from_numpy(rng.integers(0, HW, size=(B, A)).astype(np.int32)).to(dev)
    key = torch.from_numpy(rng.integers(0, 2**20, size=(B, A)).astype(np.int32)).to(dev)
    row = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A).contiguous()
    return (pix, key, torch.zeros_like(key), row), HW, A


def _winner_case(name, args, P, sentinel, log=True):
    from gradslam_tpu_torch.ops import pixel_winner_reference, winner_kernel

    got = winner_kernel(*args, P, sentinel)
    ref = pixel_winner_reference(*args, P, sentinel)
    torch.cuda.synchronize()
    _check(torch.equal(got, ref), f"winner {name}: differs from the plain version")
    B, N = args[0].shape
    if log:
        _log(f"winner {name}: B={B} N={N} P={P} blocks {winner_kernel.grid(B, N, P, winner_kernel.max_blocks())}: "
             f"equal to the plain version, {int((got != sentinel).sum())} pixels won")
    return got


def winner_paths():
    """(cell, (colors, depths, K), PointFusion options) of the four paths
    as phases 3, 4, 6 and 7 drive them."""
    golden, scannet = _golden_clip(10), _scannet_clip(16)
    HW, HW4 = 120 * 160, 240 * 320
    return (
        ("golden", golden, {}),
        ("scannet", scannet, {}),
        ("projective golden", golden, dict(assoc="projective", assoc_window=2 * HW)),
        ("projective scannet", scannet,
         dict(assoc="projective", assoc_window=3 * HW4, active_capacity=(3 * HW4) // 2)),
    )


def main_path_winner_inputs(colors, depths, K, dev, **options):
    """The ((pix, k_hi, k_lo, slot), P, sentinel) of every ``pixel_winner``
    call of a ``PointFusion(**options)`` run: one per fusion step."""
    from gradslam_tpu_torch import PointFusion, RGBDImages
    from gradslam_tpu_torch.slam import fusionutils

    calls = []
    real = fusionutils.pixel_winner

    def recording(pix, k_hi, k_lo, slot, num_pixels, sentinel):
        args = tuple(t.contiguous().clone() for t in (pix, k_hi, k_lo, slot))
        calls.append((args, int(num_pixels), int(sentinel)))
        return real(pix, k_hi, k_lo, slot, num_pixels, sentinel)

    fusionutils.pixel_winner = recording
    try:
        PointFusion(device=dev, **options)(RGBDImages(colors, depths, K, device=dev))
    finally:
        fusionutils.pixel_winner = real
    return calls


def _winner_input_stats(args, P):
    """What the data does to the kernel's atomics: candidates in [0, P),
    the distinct pixels they hit, and the share of neighbouring in-range
    candidates whose pixels are at most one apart (arena order follows the
    frame's pixel order)."""
    pix = args[0]
    inr = (pix >= 0) & (pix < P)
    n_in = int(inr.sum())
    distinct = sum(int(torch.unique(pix[b][inr[b]]).numel()) for b in range(pix.shape[0]))
    near = []
    for b in range(pix.shape[0]):
        p = pix[b][inr[b]].long()
        near.append(((p[1:] - p[:-1]).abs() <= 1).float().mean().item() if p.numel() > 1 else 0.0)
    return f"{n_in} of {pix.numel()} in range, {distinct} pixels hit, {min(near):.4f}-{max(near):.4f} of neighbours adjacent"


def _winner_design_bytes(args, P):
    """The bytes the kernel moves from L2 or HBM: the four int32 inputs
    read once (the candidates stay in registers between the folds at the
    timed shapes); for each candidate in [0, P), an 8-byte atomic on its
    pixel's key and a read of it in the second fold; the output filled and
    the other key table reset, 4 + 8 bytes a pixel."""
    pix = args[0]
    B, N = pix.shape
    n_in = int(((pix >= 0) & (pix < P)).sum())
    return 16 * B * N + 16 * n_in + 12 * B * P


def _time_winner_call(name, args, P, sentinel, library=_library_winner):
    """Kernel, plain and ``library`` (``scatter_reduce_``) times and the bound
    of one selection. The bound counts the function's bytes: four int32
    inputs read once, the int32 table written once; the design's own bytes
    and its grid go to the log."""
    from gradslam_tpu_torch.ops import pixel_winner_reference, winner_kernel

    args = tuple(a.contiguous() for a in args)
    B, N = args[0].shape
    ms = _time_ms(lambda: winner_kernel(*args, P, sentinel), reps=100)
    plain_ms = _time_ms(lambda: pixel_winner_reference(*args, P, sentinel), reps=20)
    library_ms = _time_ms(lambda: library(*args, P, sentinel), reps=20)
    bound_ms = 1e3 * (B * N * 4 * 4 + B * P * 4) / HBM_BYTES_PER_S
    design_ms = 1e3 * _winner_design_bytes(args, P) / HBM_BYTES_PER_S
    _log(f"winner timing {name} B={B} N={N} P={P}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, scatter_reduce_ "
         f"{library_ms:.6f} ms, bound {bound_ms:.6f} ms (bytes), design's bytes {design_ms:.6f} ms, "
         f"{winner_kernel.grid(B, N, P, winner_kernel.max_blocks())} blocks")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes")


def winner_phase(dev):
    """Kernel vs plain version at the diag's and the fusion paths' shapes,
    with crafted ties and edge cases; returns the kernel's JSON entry
    (without ``launches``)."""
    gen = np.random.default_rng(0)
    rmw_args, HW, A = _rmw_inputs(dev)
    got = _winner_case("pallas_rmw contract (diag shapes)", rmw_args, HW, A)
    _check(torch.equal(got, _library_rmw(rmw_args[0], rmw_args[1], rmw_args[3], HW, A)),
           "winner: scatter_reduce_ yardstick differs")

    timed = {}
    for name, B, N, P, CAP in WINNER_SHAPES:
        for variant in ("random", "ccount ties", "ray ties", "both ties", "+-0.0"):
            args = _fusion_candidates(gen, B, N, P, CAP, dev, variant)
            got = _winner_case(f"{name}, {variant}", args, P, CAP)
        _check(torch.equal(got, _library_winner(*args, P, CAP)), "winner: scatter_reduce_ yardstick differs")
        timed[name] = (args, P, CAP)
    name, B, N, P, CAP = WINNER_SHAPES[1]
    args = _fusion_candidates(gen, B, N, P, CAP, dev, "random")
    dumped = torch.full_like(args[0], P)
    got = _winner_case("all candidates dumped", (dumped, *args[1:]), P, CAP)
    _check(bool((got == CAP).all()), "winner all dumped: not the sentinel everywhere")
    one = torch.full_like(args[0], 4321)
    got = _winner_case("one pixel takes every candidate", (one, *args[1:]), P, CAP)
    _check(int((got != CAP).sum()) == B, "winner one pixel: not one winner per batch entry")
    timed["one pixel takes every candidate (hot pixel)"] = ((one, *args[1:]), P, CAP)
    wild = torch.from_numpy(gen.integers(-P, 2 * P, (B, N)).astype(np.int32)).to(dev)
    _winner_case("negative and too large pixels", (wild, *args[1:]), P, CAP)
    # full 480x640 frames (N = 2*P), a ragged P, three batch
    # entries, slots up to 2^31 - 2 with the sentinel 2^31 - 1
    H, W = 480, 640
    args = _fusion_candidates(gen, 2, 2 * H * W, H * W, 16 * H * W, dev, "both ties")
    _winner_case("480x640, both ties", args, H * W, 16 * H * W)
    timed["480x640 N=2P"] = (args, H * W, 16 * H * W)
    for name, B, N, P in (("ragged P", 2, 153_600, 76_801), ("B=3 ragged P", 3, 40_000, 19_999)):
        _winner_case(name, _fusion_candidates(gen, B, N, P, 10 * N, dev, "ray ties"), P, 10 * N)
    big = torch.from_numpy(gen.integers(2**31 - 2**20, 2**31 - 1, (2, 38_400)).astype(np.int32)).to(dev)
    args = _fusion_candidates(gen, 2, 38_400, 19_200, 10 * 19_200, dev, "ccount ties")
    _winner_case("slots near 2^31", (*args[:3], big), 19_200, 2**31 - 1)

    timed["pallas_rmw contract (diag shapes)"] = (rmw_args, HW, A)
    # the main path's own inputs: every selection of a run of each of the
    # four paths, the last fusion step of each timed
    for cell, (colors, depths, K), options in winner_paths():
        calls = main_path_winner_inputs(colors, depths, K, dev, **options)
        for n, (args, P, CAP) in enumerate(calls):
            _winner_case(f"{cell} main path, fusion step {n + 1}", args, P, CAP, log=False)
        args, P, CAP = calls[-1]
        _log(f"winner {cell} main path: {len(calls)} selections equal to the plain version; last: "
             f"B={args[0].shape[0]} N={args[0].shape[1]} P={P}, {_winner_input_stats(args, P)}")
        timed[f"{cell} main path, last fusion step"] = calls[-1]
        del calls

    timings = {}
    for name, (args, P, CAP) in timed.items():
        library = (lambda p, kh, kl, sl, P, S: _library_rmw(p, kh, sl, P, S)) if name.startswith("pallas_rmw") \
            else _library_winner
        timings[name] = _time_winner_call(name, args, P, CAP, library)
    main = WINNER_SHAPES[1][0]
    entry = dict(
        name="pixel_winner",
        route="cuda",
        source="gradslam_tpu_torch/csrc/winner.cu",
        replaces="tools/diag_winner_radix.py:110",
        max_abs_err=0,
        **timings[main],
        shape="B=2 N=153600 P=76800 (the diag's shapes, fusion key)",
        other_shapes={case: t for case, t in timings.items() if case != main},
    )
    return entry


# ---------------------------------------------------------------------------
# 6./7. projective PointFusion
# ---------------------------------------------------------------------------


def projective_phase(dev, name, colors, depths, K, window, tol_m, tol_deg=None, **options):
    """``PointFusion(assoc='projective', assoc_window=window, **options)``
    against the clip's cycled poses, with the window overflow guard."""
    B, L, H, W = colors.shape[:4]
    torch.cuda.reset_peak_memory_stats()
    pcs, poses, seconds, launches = _run_pointfusion(
        colors, depths, K, dev, assoc="projective", assoc_window=window, **options
    )
    p = poses.cpu().numpy()
    npts = pcs.num_points_per_pointcloud.cpu().numpy()
    terr, rerr = _pose_errors(p, _cycled_poses(L))
    _log(f"projective {name} B={B} L={L} {H}x{W} CAP={L * H * W} window={window} {options}: "
         f"{B * L / seconds:.3f} frames/s ({seconds:.3f} s), peak memory "
         f"{torch.cuda.max_memory_allocated()} bytes, num_points {npts.tolist()}, max translation "
         f"error {terr} m, max rotation error {rerr} deg, launches {launches}")
    _check(int(npts.max()) <= window, f"projective {name}: the map outgrew the window ({npts})")
    _check(terr < tol_m, f"projective {name}: translation off by {terr} m")
    if tol_deg is not None:
        _check(rerr < tol_deg, f"projective {name}: rotation off by {rerr} deg")
    _check_launches(f"projective {name}", launches, {"knn": 0, "winner": L})
    return launches


# ---------------------------------------------------------------------------
# 8.-10. backward through the whole sequence
# ---------------------------------------------------------------------------

TRUE_SCALE = 1.1  # the miscalibrated sensor sees depth / 1.1


def _calib_inputs(colors, depths, K, dev):
    """(rgb, clean depth, observed depth, K) on ``dev``: the observed depth
    is what a sensor of scale 1/1.1 sees, as in
    ``examples/train_depth_calib.py``."""
    rgb, clean, Kt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K))
    return rgb, clean, clean / TRUE_SCALE, Kt


def _loss_and_grads(dev, rgb, depth, K, gt, opts, capacity):
    """``slam_loss`` and its gradient with respect to (scale, bias) and the
    depth maps, each pass timed by the host clock around a synchronized run
    with the launch counts set to 0 before it; returns (loss, param grads
    (2,), depth grad, (forward s, backward s), (forward launches, backward
    launches))."""
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss

    params = DepthCalibParams(device=dev)
    depth = depth.detach().clone().requires_grad_(True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    _reset_launches()
    t0 = time.perf_counter()
    loss = slam_loss(params, rgb, depth, K, gt, opts, capacity)
    float(loss.detach())
    t1 = time.perf_counter()
    fwd = _launches()
    _reset_launches()
    loss.backward()
    sync()
    t2 = time.perf_counter()
    grads = torch.stack([params.scale.grad, params.bias.grad])
    return loss.detach(), grads, depth.grad, (t1 - t0, t2 - t1), (fwd, _launches())


def _rel_err(a, b):
    """max |a - b| over max |b|, both moved to the CPU."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def grad_phase(dev):
    """``slam_loss``'s gradient on the card against the CPU: the golden
    clip at full width (B=2, L=3), ``PointFusion()`` defaults, scale 1.0,
    the clip's own poses as the target (a larger residual than the clean
    run's trajectory, so float32 rounding moves the gradient less)."""
    from gradslam_tpu_torch import PointFusion

    colors, depths, K = _golden_clip(3)
    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    gt = _cycled_poses(L)
    out = []
    for d in (dev, torch.device("cpu")):
        rgb, _, obs, Kt = _calib_inputs(colors, depths, K, d)
        out.append(_loss_and_grads(d, rgb, obs, Kt, torch.from_numpy(gt).to(d), opts, L * H * W))
    (loss, g, gd, secs, (fwd, bwd)), (loss_c, g_c, gd_c, secs_c, _) = out
    err_p, err_d = _rel_err(g, g_c), _rel_err(gd, gd_c)
    _log(f"grad golden B={B} L={L} {H}x{W}: loss card {float(loss)!r} cpu {float(loss_c)!r}; d/d(scale, bias) "
         f"card {g.tolist()} cpu {g_c.tolist()}, max |card - cpu| / max |cpu|: params {err_p}, depth maps "
         f"{err_d}; card forward {secs[0]:.3f} s backward {secs[1]:.3f} s, cpu {secs_c[0]:.3f} s {secs_c[1]:.3f} s; "
         f"launches forward {fwd} backward {bwd}")
    for name, x in (("param", g), ("depth", gd)):
        _check(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0, f"grad golden: {name} gradient {x}")
    _check(err_p <= 1e-3 and err_d <= 1e-3, f"grad golden: card vs cpu {err_p}, {err_d}")
    _check_launches("grad golden forward", fwd, {"knn": (L - 1) * 40, "winner": L})
    _check_launches("grad golden backward", bwd, {"knn": 0, "winner": 0})


def calib_phase(dev, steps=30, L=3):
    """``examples/train_depth_calib.py``'s loop at full width: the golden
    clip at B=2, L=3 (its own frames), ``PointFusion()`` defaults, lr 0.05
    halved every ``steps / 3`` steps, the step normalized by |grad|, bias
    fixed; the gt trajectory is the clean depths' run. Returns one step's
    launches.

    Not the clip cycled to L=10: there the loss stops being smooth about 2%
    above the true scale, where the schedule's third step lands (1.140),
    and the gradient's sign changes from one scale to the next (at
    1.129-1.132 it points away from 1.1), so the loop stays between 1.12
    and 1.16 (1.1388 after 30 steps on an H100)."""
    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss
    from gradslam_tpu_torch.slam import slam_sequence

    colors, depths, K = _golden_clip(L)
    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    rgb, clean, obs, Kt = _calib_inputs(colors, depths, K, dev)
    with torch.no_grad():
        _, gt = slam_sequence(rgb, clean, Kt, None, opts, L * H * W)
    params = DepthCalibParams(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    fwd_s, bwd_s = [], []
    for i in range(steps):
        lr = 0.05 * 0.5 ** (i / max(steps / 3, 1))
        params.zero_grad()
        _reset_launches()
        t0 = time.perf_counter()
        loss = slam_loss(params, rgb, obs, Kt, gt, opts, L * H * W)
        loss_v = float(loss.detach())
        t1 = time.perf_counter()
        fwd = _launches()
        _reset_launches()
        loss.backward()
        grad = float(params.scale.grad)
        t2 = time.perf_counter()
        bwd = _launches()
        with torch.no_grad():
            params.scale -= lr * params.scale.grad / (params.scale.grad.abs() + 1e-20)
        fwd_s.append(t1 - t0)
        bwd_s.append(t2 - t1)
        _log(f"calib step {i:2d}: loss {loss_v!r} d/d(scale) {grad!r} scale {params.scale.item()!r} "
             f"forward {t1 - t0:.3f} s backward {t2 - t1:.3f} s launches forward {fwd} backward {bwd}")
        _check(np.isfinite(loss_v) and np.isfinite(grad) and grad != 0, f"calib step {i}: loss {loss_v} grad {grad}")
        _check_launches(f"calib step {i} forward", fwd, {"knn": (L - 1) * 40, "winner": L})
        _check_launches(f"calib step {i} backward", bwd, {"knn": 0, "winner": 0})
    scale = params.scale.item()
    _log(f"calib golden B={B} L={L} {H}x{W}, {steps} steps in {time.perf_counter() - t_all:.3f} s: scale "
         f"{scale!r} (true {TRUE_SCALE}, |error| {abs(scale - TRUE_SCALE)!r}), bias {params.bias.item()!r}; "
         f"seconds a step, median: forward {float(np.median(fwd_s)):.3f}, backward {float(np.median(bwd_s)):.3f}; "
         f"peak memory {torch.cuda.max_memory_allocated()} bytes")
    _check(abs(scale - TRUE_SCALE) <= 0.01, f"calib: scale {scale}, true {TRUE_SCALE}")
    _check(params.bias.item() == 0.0, "calib: the bias moved")
    return {k: fwd[k] + bwd[k] for k in fwd}


def backward_scannet_phase(dev):
    """One forward and backward of ``slam_loss`` at the ScanNet geometry
    (B=2, L=16, 240x320, a 1.23M-row arena), against the clip's poses."""
    from gradslam_tpu_torch import PointFusion

    colors, depths, K = _scannet_clip(16)
    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    rgb, _, obs, Kt = _calib_inputs(colors, depths, K, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, g, gd, secs, (fwd, bwd) = _loss_and_grads(
        dev, rgb, obs, Kt, torch.from_numpy(_cycled_poses(L)).to(dev), opts, L * H * W
    )
    _log(f"backward scannet B={B} L={L} {H}x{W} CAP={L * H * W}: loss {float(loss)!r}, d/d(scale, bias) "
         f"{g.tolist()}, max |d/d(depth)| {float(gd.abs().max())!r}; forward {secs[0]:.3f} s, backward "
         f"{secs[1]:.3f} s, peak memory {torch.cuda.max_memory_allocated()} bytes; launches forward {fwd} "
         f"backward {bwd}")
    for name, x in (("param", g), ("depth", gd)):
        _check(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0, f"backward scannet: {name} gradient")
    _check_launches("backward scannet forward", fwd, {"knn": (L - 1) * 40, "winner": L})
    _check_launches("backward scannet backward", bwd, {"knn": 0, "winner": 0})
    return {k: fwd[k] + bwd[k] for k in fwd}


# ---------------------------------------------------------------------------
# 11. the metrics
# ---------------------------------------------------------------------------


def trajectory_metrics_phase(dev, golden_poses):
    """ATE and RPE of phase 3's poses against the clip's cycled poses, on
    the card and on the CPU."""
    from gradslam_tpu_torch.metrics import ate_rmse, rpe

    gt = _cycled_poses(golden_poses.shape[1])
    vals = []
    for d in (dev, torch.device("cpu")):
        p, g = torch.from_numpy(golden_poses).to(d), torch.from_numpy(gt).to(d)
        vals.append(torch.stack([ate_rmse(p, g), *rpe(p, g)]).cpu().double())
    card, cpu = vals
    err = float((card - cpu).abs().max())
    _log(f"metrics golden: (ate_rmse, rpe translation, rpe rotation) per batch entry: card "
         f"{card.tolist()} cpu {cpu.tolist()}, max |card - cpu| {err!r}")
    _check(bool(torch.isfinite(card).all()), "metrics: ATE / RPE not finite")
    _check(err <= 1e-6, f"metrics: card vs cpu {err}")


def reconstruction_metrics_phase(dev, name, colors, depths, K):
    """``chamfer_distance`` and ``map_accuracy`` between the maps of a
    gradICP run and a ground-truth-odometry run of one clip, then the KNN
    kernel at the shapes they give it against the plain version on the
    card, with the targets cut at the last valid one (the same function: no
    target beyond it is valid). The plain version's one call a direction is
    its timing too: at these sizes (0.4-11 s) its host dispatch is far
    shorter than its device time.

    Returns (launches of the metrics' run, {shape: timings})."""
    from gradslam_tpu_torch import PointFusion, RGBDImages
    from gradslam_tpu_torch.metrics import chamfer_distance, map_accuracy
    from gradslam_tpu_torch.ops.knn import knn_kernel, knn_reference, prepare_targets

    B, L, H, W = colors.shape[:4]
    maps = {}
    for odom in ("gradicp", "gt"):
        poses = _cycled_poses(L) if odom == "gt" else None
        pcs, _ = PointFusion(odom=odom, device=dev)(RGBDImages(colors, depths, K, poses, device=dev))
        maps[odom] = (pcs.points_padded, pcs.nonpad_mask)
    (a, va), (b, vb) = maps["gradicp"], maps["gt"]
    torch.cuda.synchronize()
    _reset_launches()
    cd = chamfer_distance(a, b, va, vb)
    acc, comp = map_accuracy(a, b, va, vb)
    torch.cuda.synchronize()
    launches = _launches()
    _log(f"metrics {name} B={B} CAP={a.shape[1]}: num_points gradicp {va.sum(1).tolist()} gt "
         f"{vb.sum(1).tolist()}; chamfer {cd.tolist()}, accuracy {acc.tolist()}, completeness "
         f"{comp.tolist()} (5 cm); launches {launches}")
    for x in (cd, acc, comp):
        _check(bool(torch.isfinite(x).all()), f"metrics {name}: not finite")
    _check(bool((acc > 0.5).all() and (comp > 0.5).all()), f"metrics {name}: accuracy {acc}, completeness {comp}")
    _check_launches(f"metrics {name}", launches, {"knn": 4, "winner": 0})

    timings = {}
    for direction, (src, tgt, val) in (("gradicp->gt", (a, b, vb)), ("gt->gradicp", (b, a, va))):
        src = src.contiguous()
        prep = prepare_targets(tgt, val)
        d_k, i_k = knn_kernel(src, prep.packed, prep.limit)
        T = int(prep.limit.max())
        tgt_t, val_t = tgt[:, :T].contiguous(), val[:, :T]
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        d_p, i_p = knn_reference(src, tgt_t, val_t)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        _check(torch.equal(i_k, i_p) and torch.equal(d_k, d_p),
               f"knn metrics {name} {direction}: differs from the plain version")
        case = f"chamfer {name} {direction} B={B} S={src.shape[1]} T={tgt.shape[1]} limit {prep.limit.tolist()}"
        _log(f"knn {case}: every source bit-equal to the plain version")
        if direction != "gradicp->gt":
            continue
        ms = _time_ms(lambda: knn_kernel(src, prep.packed, prep.limit), reps=3, warmup=1)
        bound_ms, bound_by = _knn_bound(src, int(prep.limit.sum()), int(val.sum()))
        # torch.cdist needs the (B, S, T) float32 distances at once
        fits = B * src.shape[1] * tgt.shape[1] * 4 < torch.cuda.mem_get_info()[0] // 2
        library_ms = None
        if fits:
            library_ms = _time_ms(
                lambda: torch.cdist(src, tgt, compute_mode="donot_use_mm_for_euclid_dist")
                .masked_fill_(~val[:, None, :], torch.inf).min(-1),
                reps=3, warmup=1,
            )
        timings[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        _log(f"knn timing {case}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, cdist "
             f"{'%.6f ms' % library_ms if fits else 'does not fit in memory'}, bound {bound_ms:.6f} "
             f"ms ({bound_by}), tiles {knn_kernel.tiles(B, src.shape[1], tgt.shape[1])}")
    return launches, timings


# ---------------------------------------------------------------------------
# 12. block-gated PointFusion at the ScanNet geometry
# ---------------------------------------------------------------------------

GATE_BLOCK = 4096  # rows a block: 300 blocks in the 1,228,800-row arena
DOT_TH = 0.93969262  # cos 20 deg, the fusion's normal gate


def gated_run_inputs(colors, depths, K, dev, block_size):
    """One ``PointFusion(block_size=...)`` run that records every winner
    selection (as ``main_path_winner_inputs``) and, for each fusion step,
    the visible blocks of each batch entry and the visible capacity."""
    from gradslam_tpu_torch import PointFusion, RGBDImages
    from gradslam_tpu_torch.slam import fusionutils

    calls, visible = [], []
    real_w, real_v = fusionutils.pixel_winner, fusionutils.visible_subarena

    def rec_winner(pix, k_hi, k_lo, slot, num_pixels, sentinel):
        calls.append((tuple(t.contiguous().clone() for t in (pix, k_hi, k_lo, slot)), int(num_pixels), int(sentinel)))
        return real_w(pix, k_hi, k_lo, slot, num_pixels, sentinel)

    def rec_visible(map_state, pose, intrinsics, H, W, block_size, visible_capacity):
        out = real_v(map_state, pose, intrinsics, H, W, block_size, visible_capacity)
        blocks = out[2].reshape(out[2].shape[0], visible_capacity, block_size).any(-1).sum(1)
        visible.append((blocks.tolist(), visible_capacity))
        return out

    fusionutils.pixel_winner, fusionutils.visible_subarena = rec_winner, rec_visible
    try:
        PointFusion(device=dev, block_size=block_size)(RGBDImages(colors, depths, K, device=dev))
    finally:
        fusionutils.pixel_winner, fusionutils.visible_subarena = real_w, real_v
    return calls, visible


def gated_scannet_phase(dev, ungated_poses, ungated_npts, reps=3):
    """``PointFusion(block_size=4096)`` at the ScanNet geometry against
    phase 4's ungated run (translations within 5e-3 m, the JAX package's
    gate), its runs interleaved with ungated ones for frames/s (medians of
    ``reps``), every winner selection against the plain version, and the
    visible blocks of each frame below the visible capacity (else blocks
    were dropped). Returns (launches, {run: frames/s})."""
    colors, depths, K = _scannet_clip(16)
    B, L, H, W = colors.shape[:4]
    CAP = L * H * W
    runs = {"ungated": [], "gated": []}
    for _ in range(reps):
        for name, options in (("ungated", {}), ("gated", dict(block_size=GATE_BLOCK))):
            pcs, poses, seconds, launches = _run_pointfusion(colors, depths, K, dev, **options)
            _check_launches(f"{name} scannet", launches, {"knn": (L - 1) * 40, "winner": L})
            runs[name].append((seconds, poses.cpu().numpy(), pcs.num_points_per_pointcloud.cpu().numpy()))
    fps = {name: B * L / float(np.median([r[0] for r in rs])) for name, rs in runs.items()}
    _, p, npts = runs["gated"][0]
    terr = float(np.linalg.norm(p[..., :3, 3] - ungated_poses[..., :3, 3], axis=-1).max())
    same = all(np.array_equal(r[1], p) for r in runs["gated"])
    _log(f"gated scannet B={B} L={L} {H}x{W} CAP={CAP} block {GATE_BLOCK} ({-(-CAP // GATE_BLOCK)} blocks): "
         f"frames/s median of {reps}: gated {fps['gated']:.3f} "
         f"{[round(B * L / r[0], 3) for r in runs['gated']]}, ungated {fps['ungated']:.3f} "
         f"{[round(B * L / r[0], 3) for r in runs['ungated']]}; max translation from phase 4's ungated run "
         f"{terr!r} m; num_points gated {npts.tolist()} ungated {ungated_npts.tolist()}; gated runs "
         f"{'bit-identical' if same else 'differ'} across runs; launches {launches}")
    _check(bool(np.isfinite(p).all()), "gated scannet: poses are not finite")
    _check(terr < 5e-3, f"gated scannet: {terr} m from the ungated run")

    calls, visible = gated_run_inputs(colors, depths, K, dev, GATE_BLOCK)
    _check(len(calls) == L and len(visible) == L, f"gated scannet: {len(calls)} selections, {len(visible)} gates")
    for n, (args, P, sentinel) in enumerate(calls):
        _winner_case(f"gated scannet main path, fusion step {n + 1}", args, P, sentinel, log=False)
    V = visible[0][1]
    _log(f"gated scannet: {L} selections equal to the plain version; visible blocks per fusion step "
         f"(of at most {V}): {[v for v, _ in visible]}")
    _check(max(max(v) for v, _ in visible) < V, f"gated scannet: the visible blocks reached the capacity {V}")
    return launches, fps


# ---------------------------------------------------------------------------
# 13. semantic labels at the ScanNet geometry
# ---------------------------------------------------------------------------


def labels_phase(dev, name, seed=0, **options):
    """``slam_sequence`` with ``labels_seq`` at the ScanNet geometry, with
    no labels, a constant label 7 and 20 classes drawn per pixel: poses and
    map channels 0-9 bit-identical to the run without labels and the same
    launches; under the constant label every live label is 7 and its
    confidence the ccount bit for bit; the 20 classes stay integers in
    [0, 20) with confidences >= 0. Returns the constant-label run's
    launches."""
    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.slam import slam_sequence
    from gradslam_tpu_torch.structures import map_mask

    colors, depths, K = _scannet_clip(16)
    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev, **options).opts
    rgb, depth, Kt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K))
    classes = np.random.default_rng(seed).integers(0, 20, (B, L, H, W)).astype(np.float32)
    label_sets = {
        "no labels": None,
        "constant 7": torch.full((B, L, H, W), 7.0, device=dev),
        "20 classes": torch.from_numpy(classes).to(dev),
    }
    runs = {}
    for lname, labels in label_sets.items():
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        m, poses = slam_sequence(rgb, depth, Kt, None, opts, L * H * W, labels_seq=labels)
        torch.cuda.synchronize()
        runs[lname] = (m, poses, _launches(), time.perf_counter() - t0)
    m0, p0, launches0, _ = runs["no labels"]
    _check_launches(f"labels {name}", launches0, {"knn": 0 if opts.assoc == "projective" else (L - 1) * 40,
                                                    "winner": L})
    for lname in ("constant 7", "20 classes"):
        m, p, launches, seconds = runs[lname]
        live = map_mask(m)
        labs, conf = m.labels[live], m.label_conf[live]
        _log(f"labels {name} B={B} L={L} {H}x{W} {options}, {lname}: {B * L / seconds:.3f} frames/s, num_points "
             f"{m.num_points.tolist()}, poses and channels 0-9 bit-identical to the run without labels: "
             f"{torch.equal(p, p0) and torch.equal(m.data[..., :10], m0.data[..., :10])}, labels "
             f"{torch.unique(labs).numel()} distinct in [{float(labs.min())}, {float(labs.max())}], confidence "
             f"[{float(conf.min())!r}, {float(conf.max())!r}], launches {launches}")
        _check(torch.equal(p, p0), f"labels {name} {lname}: poses differ from the run without labels")
        _check(torch.equal(m.num_points, m0.num_points) and torch.equal(m.data[..., :10], m0.data[..., :10]),
               f"labels {name} {lname}: map channels 0-9 differ from the run without labels")
        _check(launches == launches0, f"labels {name} {lname}: launches {launches} vs {launches0}")
        if lname == "constant 7":
            _check(bool((labs == 7.0).all()), f"labels {name}: a live label is not 7")
            _check(torch.equal(conf, m.ccounts[..., 0][live]), f"labels {name}: label_conf differs from ccount")
        else:
            _check(bool((labs == labs.round()).all() and (labs >= 0).all() and (labs < 20).all()),
                   f"labels {name}: a live label is not an integer in [0, 20)")
            _check(bool((conf >= 0).all()), f"labels {name}: a negative label confidence")
    return runs["constant 7"][2]


# ---------------------------------------------------------------------------
# 14. the object-level API
# ---------------------------------------------------------------------------


def _recording(module, name, calls, keep_out=False):
    """Replaces ``module.name`` by a wrapper that appends each call's
    arguments (tensors cloned), and its output with ``keep_out``, to
    ``calls``; returns a function that restores it."""
    real = getattr(module, name)
    copy = lambda x: x.detach().clone() if torch.is_tensor(x) else x

    def wrapper(*args):
        out = real(*args)
        calls.append((tuple(copy(a) for a in args), out if keep_out else None))
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def _drive_object_api(device, knn_calls, winner_calls):
    """The providers on the golden clip's frames 0 -> 1 (the map frame 0's
    whole cloud, the source frame 1 at every 4th pixel), then
    ``find_correspondences`` and ``update_map_fusion`` over frames 0-2, with
    the KNN and winner calls recorded."""
    from gradslam_tpu_torch import Pointclouds, RGBDImages
    from gradslam_tpu_torch.odometry import (
        GradICPOdometryProvider,
        GroundTruthOdometryProvider,
        ICPOdometryProvider,
        downsample_rgbdimages,
        icputils,
    )
    from gradslam_tpu_torch.slam import find_correspondences, fusionutils, update_map_fusion
    from gradslam_tpu_torch.structures import pointclouds_from_rgbdimages

    d = DATA / "msrd_b2s3"
    c, dep, K, P = (np.load(d / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics", "poses"))
    frame = lambda s: RGBDImages(c[:, s : s + 1], dep[:, s : s + 1], K, P[:, s : s + 1], device=device)
    restore = [_recording(icputils, "knn", knn_calls), _recording(fusionutils, "pixel_winner", winner_calls, True)]
    try:
        out = {"gt": GroundTruthOdometryProvider().provide(frame(0), frame(1))}
        maps_pc, frames_pc = pointclouds_from_rgbdimages(frame(0)), downsample_rgbdimages(frame(1), 4)
        out["icp"] = ICPOdometryProvider().provide(maps_pc, frames_pc)
        out["gradicp"] = GradICPOdometryProvider().provide(maps_pc, frames_pc)
        pc, tables = Pointclouds(), []
        for s in range(3):
            if s:
                tables.append(find_correspondences(pc, frame(s), 0.05, DOT_TH))
            pc = update_map_fusion(pc, frame(s), 0.05, DOT_TH, 0.6)
    finally:
        for r in restore:
            r()
    out["tables"], out["map"] = tables, pc
    return out


def _check_knn_calls(phase, calls):
    """Each recorded ``knn(src, targets)`` call, run again on the kernel,
    against the plain version on the same inputs."""
    from gradslam_tpu_torch.ops.knn import knn, knn_reference

    for n, ((src, tgt, *rest), _) in enumerate(calls):
        dk, ik = knn(src, tgt, *rest)
        dp, ip = knn_reference(src, tgt.tgt, tgt.valid)
        _check(torch.equal(ik, ip) and torch.equal(dk, dp), f"{phase}: KNN call {n} differs from the plain version")


def object_api_phase(dev):
    """The odometry providers and the table-based fusion API on the card
    against the CPU, every KNN and winner call of the card's run against
    the plain version, and the GradICP provider recovering a known motion
    of a whole 240x320 frame. Returns the card run's launches."""
    from gradslam_tpu_torch import RGBDImages
    from gradslam_tpu_torch.geometry import se3_exp
    from gradslam_tpu_torch.odometry import GradICPOdometryProvider, icputils
    from gradslam_tpu_torch.ops import pixel_winner_reference
    from gradslam_tpu_torch.structures import pointclouds_from_rgbdimages

    torch.cuda.synchronize()
    _reset_launches()
    knn_calls, winner_calls = [], []
    card = _drive_object_api(dev, knn_calls, winner_calls)
    # the GradICP provider on a whole ScanNet-geometry frame moved by T_true
    colors, depths, K = _scannet_clip(1)
    src = pointclouds_from_rgbdimages(RGBDImages(colors, depths, K, device=dev))
    T_true = se3_exp(torch.tensor([0.01, -0.01, 0.02, 0.05, -0.04, 0.03], device=dev))
    big_calls = []
    restore = _recording(icputils, "knn", big_calls)
    try:
        T = GradICPOdometryProvider(numiters=20, dist_thresh=0.2).provide(src.transform(T_true), src)
    finally:
        restore()
    torch.cuda.synchronize()
    launches = _launches()
    _check(launches == {"knn": len(knn_calls) + len(big_calls), "winner": len(winner_calls)},
           f"object api: launches {launches} for {len(knn_calls) + len(big_calls)} KNN and "
           f"{len(winner_calls)} winner calls")
    cpu_knn, cpu_winner = [], []
    cpu = _drive_object_api(torch.device("cpu"), cpu_knn, cpu_winner)

    t_err = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in ("gt", "icp", "gradicp")}
    _check(all(e <= 1e-4 for e in t_err.values()), f"object api: providers card vs cpu {t_err}")
    _check_knn_calls("object api", knn_calls)
    _check_knn_calls("object api scannet frame", big_calls)
    _check(len(winner_calls) == len(cpu_winner) == 5, f"object api: {len(winner_calls)} winner selections")
    for n, ((args, out), (_, out_cpu)) in enumerate(zip(winner_calls, cpu_winner)):
        _check(torch.equal(out, pixel_winner_reference(*args)), f"object api: selection {n} differs from the plain version")
        _check(torch.equal(out.cpu(), out_cpu), f"object api: selection {n} (pix_corr) differs from the CPU's")
    for n, (a, b) in enumerate(zip(card["tables"], cpu["tables"])):
        _check(torch.equal(a.cpu(), b), f"object api: correspondence table {n} differs from the CPU's")
    mc, mp = card["map"], cpu["map"]
    map_err = float((mc.points_padded.cpu() - mp.points_padded).abs().max())
    _check(torch.equal(mc.num_points_per_pointcloud.cpu(), mp.num_points_per_pointcloud) and map_err <= 1e-4,
           f"object api: fused map card vs cpu, num_points {mc.num_points_per_pointcloud.tolist()} vs "
           f"{mp.num_points_per_pointcloud.tolist()}, points {map_err}")
    T_err = float((T[:, 0] - T_true).abs().max())
    _log(f"object api golden: providers card vs cpu max |dT| {t_err}; {len(knn_calls)} KNN calls bit-equal to the "
         f"plain version; {len(winner_calls)} winner selections bit-equal to the plain version and the CPU's; "
         f"tables {[tuple(t.shape) for t in card['tables']]} equal to the CPU's; fused map num_points "
         f"{mc.num_points_per_pointcloud.tolist()}, max |points - cpu| {map_err!r}")
    _log(f"object api scannet frame B={src.points_padded.shape[0]} N={src.points_padded.shape[1]} "
         f"({src.num_points_per_pointcloud.tolist()} valid): GradICP recovers T_true within {T_err!r} "
         f"(max |T - T_true|), {len(big_calls)} KNN calls bit-equal to the plain version; launches {launches}")
    _check(T_err < 5e-3, f"object api: GradICP off T_true by {T_err}")
    return launches


# ---------------------------------------------------------------------------
# 15.-17. from files on disk to a managed map
# ---------------------------------------------------------------------------

E2E_HW = (480, 640)  # the TUM frame's own size: the loader's intrinsics need no scaling
E2E_FRAMES = 32
E2E_SEQLEN = 16
E2E_SEGMENT = 1  # the watermark is read after every frame
E2E_VOXEL = 0.02  # the package default: a 2 cm cell holds ~12 of the scene's 5.7 mm pixel footprints at 3 m
SCANNET_VOXEL = 0.002  # the voxel of the JAX package's trajectory bound test (tests/slam/test_lifecycle.py)
# Phase 17 compares two runs through two compactions, so one decision at a
# threshold (a point's cell, a fusion gate) taken differently by the card
# and the CPU's last-bit differences ends the comparison; at 5 mm, finer
# than the golden clip's pixel footprint, no such decision flips, while at
# 2 mm, 1 cm and 2 cm one does (tools/compaction_sensitivity.py)
GRAD_VOXEL = 0.005
VOXEL_CHECK_SIZES = (0.02, 0.01)  # the package's defaults: managed and compacted runs
# Arenas in units of H*W, small enough that the 0.9 watermark is crossed:
# fused, the 480x640 scene peaks at 1.57*H*W rows over 16 frames and the
# cycled ScanNet-geometry clip at 2.11*H*W over 32, so arenas of 2*H*W and
# 6*H*W would never compact (an H100 run of this script)
E2E_CAPACITY_HW = 1.25
SCANNET_CAPACITY_HW = 2.0
E2E_MIN_RECLAIM = 0.5  # each compaction frees at least this share of the live rows
E2E_MAX_FILL = 0.95  # the arena at its fullest, as a share of its capacity


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _write_png(path, img: np.ndarray) -> None:
    """A PNG of an (H, W, 3) uint8 or (H, W) uint16 image, unfiltered rows,
    with the standard library's zlib (the card's Python has no image
    writer)."""
    import struct
    import zlib

    H, W = img.shape[:2]
    color, depth = (0, 16) if img.dtype == np.uint16 else (2, 8)
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                     + _png_chunk(b"IDAT", zlib.compress(raw, 1)) + _png_chunk(b"IEND", b""))


def _render_e2e(dev, n, H, W):
    """``tests/integration/test_real_format_e2e.py``'s scene at H x W: its
    textured height field ray-cast (30 fixed-point steps, float64 on the
    card) from its translating camera, with the TUM loader's intrinsics.
    Returns (colors uint8 (n, H, W, 3), depth m float64 (n, H, W), poses
    (n, 4, 4) float32)."""
    f64 = dict(dtype=torch.float64, device=dev)
    dx = ((torch.arange(W, **f64) - 319.5 * W / 640) / (525.0 * W / 640))[None, :].expand(H, W)
    dy = ((torch.arange(H, **f64) - 239.5 * H / 480) / (525.0 * H / 480))[:, None].expand(H, W)
    z = lambda x, y: 3.0 + 0.25 * torch.sin(1.7 * x + 0.5) * torch.cos(1.9 * y) + 0.15 * torch.sin(0.9 * y + 1.0)
    colors, depths, poses = [], [], []
    for k in range(n):
        t = (0.03 * k, 0.015 * k, 0.01 * k)
        s = torch.full((H, W), 3.0, **f64)
        for _ in range(30):
            s = z(t[0] + s * dx, t[1] + s * dy) - t[2]
        x, y = t[0] + s * dx, t[1] + s * dy
        tex = torch.stack([0.5 + 0.45 * torch.sin(3.0 * x), 0.5 + 0.45 * torch.cos(2.0 * y + 1.0),
                           0.5 + 0.45 * torch.sin(1.3 * (x + y))], dim=-1)
        colors.append((tex * 255).to(torch.uint8).cpu().numpy())
        depths.append(s.cpu().numpy())
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = t
        poses.append(T)
    return np.stack(colors), np.stack(depths), np.stack(poses)


def _write_tum_tree(seq, dev, n, H, W):
    """Writes the rendered scene as a TUM sequence directory: 8-bit color
    (with +-1 LSB of noise, so the decode costs what a camera frame's
    does), 16-bit depth at x5000, rgb.txt / depth.txt / groundtruth.txt."""
    colors, depths, poses = _render_e2e(dev, n, H, W)
    rng = np.random.default_rng(7)
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    jobs, lines = [], {"rgb": [], "depth": [], "groundtruth": []}
    for i in range(n):
        t = f"{100.0 + i * 0.033:.6f}"
        noisy = np.clip(colors[i].astype(np.int16) + rng.integers(-1, 2, colors[i].shape), 0, 255).astype(np.uint8)
        jobs += [(seq / "rgb" / f"{t}.png", noisy),
                 (seq / "depth" / f"{t}.png", np.round(depths[i] * 5000.0).astype(np.uint16))]
        lines["rgb"].append(f"{t} rgb/{t}.png")
        lines["depth"].append(f"{t} depth/{t}.png")
        tx, ty, tz = poses[i][:3, 3]
        lines["groundtruth"].append(f"{t} {tx:.6f} {ty:.6f} {tz:.6f} 0 0 0 1")
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda job: _write_png(*job), jobs))
    for name, rows in lines.items():
        (seq / f"{name}.txt").write_text(f"# {name}\n" + "\n".join(rows))


class _Recorder:
    """Replaces ``pixel_winner`` in the modules that call it, ``knn`` in the
    odometry and ``compact_slam_state`` in the lifecycle by wrappers that
    keep each selection's inputs and output, every ``knn_every``-th KNN
    call's, and each compaction's frame index, device time, input arena
    and live rows after it."""

    def __init__(self, knn_every=50):
        from gradslam_tpu_torch.odometry import icputils
        from gradslam_tpu_torch.slam import fusionutils, lifecycle

        self.winners, self.knns, self.compactions = [], [], []
        self.n_knn, self.n_fusion = 0, 0
        clone = lambda xs: tuple(x.detach().clone() if torch.is_tensor(x) else x for x in xs)

        def winner(module):
            real = module.pixel_winner

            def wrapped(*args):
                out = real(*args)
                self.winners.append((module.__name__.rsplit(".", 1)[-1], clone(args), out.clone()))
                self.n_fusion += module is fusionutils
                return out
            return real, wrapped

        def knn(*args):
            out = real_knn(*args)
            if self.n_knn % knn_every == 0:
                src, tgt = args[:2]
                self.knns.append((src.detach().clone(), tgt.tgt.clone(), tgt.valid.clone(), clone(out)))
            self.n_knn += 1
            return out

        def compact(state, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_compact(state, *args, **kwargs)
            torch.cuda.synchronize()
            self.compactions.append((self.n_fusion, 1e3 * (time.perf_counter() - t0), state.map_state,
                                     out.map_state.num_points))
            return out

        real_knn, real_compact = icputils.knn, lifecycle.compact_slam_state
        self._restore = [(icputils, "knn", real_knn), (lifecycle, "compact_slam_state", real_compact)]
        for module in (fusionutils, lifecycle):
            real, wrapped = winner(module)
            self._restore.append((module, "pixel_winner", real))
            module.pixel_winner = wrapped
        icputils.knn, lifecycle.compact_slam_state = knn, compact

    def close(self):
        for module, name, real in self._restore:
            setattr(module, name, real)

    def check(self, phase):
        """Every selection and every kept KNN call against its plain version."""
        from gradslam_tpu_torch.ops import knn_reference, pixel_winner_reference

        for n, (where, args, out) in enumerate(self.winners):
            _check(torch.equal(out, pixel_winner_reference(*args)),
                   f"{phase}: selection {n} ({where}) differs from the plain version")
        for n, (src, tgt, valid, (d, i)) in enumerate(self.knns):
            dp, ip = knn_reference(src, tgt, valid)
            _check(torch.equal(i, ip) and torch.equal(d, dp), f"{phase}: KNN call {n} differs from the plain version")
        refresh = sum(w == "lifecycle" for w, _, _ in self.winners)
        return (f"{len(self.winners)} selections ({refresh} of them the refresh's) and {len(self.knns)} of "
                f"{self.n_knn} KNN calls bit-equal to the plain version")


def _managed_run(dev, rgb, depth, K, opts, **kwargs):
    """``slam_sequence_managed`` timed by the host clock around a
    synchronized run, with the launch counts set to 0 just before it and
    every selection, each compaction and some KNN calls recorded; returns
    (map, poses, seconds, launches, recorder)."""
    from gradslam_tpu_torch.slam import slam_sequence_managed

    rec = _Recorder()
    try:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        m, poses = slam_sequence_managed(rgb, depth, K, None, opts, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
    finally:
        rec.close()
    return m, poses, seconds, launches, rec


def _check_voxel_cells(phase, m, sizes=VOXEL_CHECK_SIZES):
    """The voxel merge of the arena ``m`` on the card against the CPU at
    each voxel size: the cell order and boundaries (the integer structure)
    bit-equal, the merged rows within 1e-6. Logs how many points' cells a
    division by a host scalar (a multiply by its float32 reciprocal on the
    card) would move."""
    from gradslam_tpu_torch.ops import voxel
    from gradslam_tpu_torch.structures import map_mask

    live = map_mask(m)
    pts = m.data[..., 0:3]
    origin = torch.zeros(3, dtype=pts.dtype, device=pts.device)
    moved = {}
    for size in sizes:
        card = voxel._sort_by_voxel(pts, live, size, origin)
        cpu = voxel._sort_by_voxel(pts.cpu(), live.cpu(), size, origin.cpu())
        _check(all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
               f"{phase}: the voxel cells at {size} differ between the card and the CPU")
        rows, out_live = voxel.voxel_merge_rows(m.data, live, size)
        rows_cpu, out_live_cpu = voxel.voxel_merge_rows(m.data.cpu(), live.cpu(), size)
        err = float((rows.cpu() - rows_cpu).abs().max())
        _check(torch.equal(out_live.cpu(), out_live_cpu) and err <= 1e-6,
               f"{phase}: voxel merge at {size} card vs cpu, max |rows - cpu| {err}")
        by_scalar = torch.floor(pts / size) != torch.floor(pts / torch.full((), size, device=pts.device))
        moved[size] = (int((by_scalar.any(-1) & live).sum()), int(out_live.sum()), err)
    return (f"voxel cells card vs cpu at {list(sizes)} bit-equal over {int(live.sum())} live rows (merged rows max "
            f"|card - cpu|, a host-scalar divisor's moved points, cells: "
            f"{ {k: (v[2], v[0], v[1]) for k, v in moved.items()} })")


def _ply_vertices(path) -> int:
    """The vertex count in a binary PLY file's header, checked against the
    file's size (27 bytes a vertex: position, normal, color)."""
    blob = path.read_bytes()
    head = blob[: blob.index(b"end_header\n") + len(b"end_header\n")]
    n = int(next(l for l in head.decode().splitlines() if l.startswith("element vertex")).split()[-1])
    _check(len(blob) - len(head) == 27 * n, f"ply: {len(blob) - len(head)} bytes for {n} vertices")
    return n


def files_phase(dev, capacity_hw=E2E_CAPACITY_HW, voxel_size=E2E_VOXEL, segment_len=E2E_SEGMENT):
    """Phase 15: a rendered 480x640 sequence written as a TUM tree, read
    back by ``TUM`` and ``DataLoader(to_device=card)``, mapped by
    ``slam_sequence_managed`` in an arena of 1.25*H*W rows, ATE against the
    files' ground truth, the rows each compaction reclaims and the headroom; a checkpoint at a compacting boundary resumed from
    its file, bitwise equal to the uninterrupted run; the map as PLY.
    Returns (launches, {kernel: {case: timing}})."""
    import tempfile

    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.datasets import TUM, DataLoader
    from gradslam_tpu_torch.metrics import ate_rmse
    from gradslam_tpu_torch.slam import slam_sequence_managed
    from gradslam_tpu_torch.structures import map_to_pointclouds
    from gradslam_tpu_torch.utils import load_slam_state, save_slam_state
    from gradslam_tpu_torch.viz import pointclouds_to_ply

    H, W = E2E_HW
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_tum_tree(root / "rgbd_dataset_render", dev, E2E_FRAMES, H, W)
        write_s = time.perf_counter() - t0
        ds = TUM(str(root), seqlen=E2E_SEQLEN, height=H, width=W)
        _check(len(ds) == E2E_FRAMES // E2E_SEQLEN, f"files: {len(ds)} sequences")
        t0 = time.perf_counter()
        batches = list(DataLoader(ds, batch_size=2, num_workers=4, to_device=dev))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        _check(len(batches) == 1, f"files: {len(batches)} batches")
        colors, depths, K, gt, _, names, _ = batches[0]
        B, L = colors.shape[:2]
        _check(tuple(colors.shape) == (2, E2E_SEQLEN, H, W, 3) and colors.device == dev, "files: color batch")

        opts = PointFusion(device=dev).opts
        kw = dict(capacity=int(capacity_hw * H * W), watermark=0.9, segment_len=segment_len, policy="voxel", voxel_size=voxel_size)
        torch.cuda.reset_peak_memory_stats()
        m, poses, seconds, launches, rec = _managed_run(dev, colors, depths, K, opts, **kw)
        peak = torch.cuda.max_memory_allocated()
        ate = ate_rmse(poses, gt)
        n_comp = len(rec.compactions)
        checked = rec.check("files")
        cap = kw["capacity"]
        before = [c[2].num_points for c in rec.compactions]
        reclaimed = [(b - c[3]).tolist() for b, c in zip(before, rec.compactions)]
        share = min([float(((b - c[3]) / b).min()) for b, c in zip(before, rec.compactions)], default=0.0)
        fullest = max([int(b.max()) for b in before] + [int(m.num_points.max())])
        _log(f"files tum B={B} L={L} {H}x{W}: written in {write_s:.3f} s, decoded ({ds.decode_route}) at "
             f"{E2E_FRAMES / decode_s:.3f} frames/s; managed CAP={cap} segment {segment_len} voxel "
             f"{voxel_size}: {B * L / seconds:.3f} frames/s ({seconds:.3f} s), {n_comp} compactions at frames "
             f"{[c[0] for c in rec.compactions]} taking {[round(c[1], 3) for c in rec.compactions]} ms (live "
             f"{[b.tolist() for b in before]} before, {[c[3].tolist() for c in rec.compactions]} after, reclaimed "
             f"{reclaimed}, least share {share:.4f}), num_points {m.num_points.tolist()}, headroom at the end "
             f"{(cap - m.num_points).tolist()}, fullest {fullest} ({fullest / cap:.4f} of CAP), ATE {ate.tolist()} m, "
             f"peak memory {peak} bytes, launches {launches}; {checked}")
        _check(bool((ate < 5e-3).all()), f"files: ATE {ate.tolist()}")
        _check(n_comp >= 2, f"files: {n_comp} compactions")
        _check(share >= E2E_MIN_RECLAIM, f"files: a compaction reclaimed only {share:.4f} of the live rows")
        _check(fullest <= E2E_MAX_FILL * cap, f"files: the arena reached {fullest} of {cap} rows")
        _log(f"files: {_check_voxel_cells('files', rec.compactions[0][2])}")
        _check_launches("files", launches, {"knn": (L - 1) * 40, "winner": L + n_comp})

        # the last compacting boundary: interrupt there, save, load, resume
        t_c = rec.compactions[-1][0]
        m1, p1 = slam_sequence_managed(colors[:, :t_c], depths[:, :t_c], K, None, opts, **kw)
        save_slam_state(str(root / "boundary.npz"), m1, p1[:, -1])
        m_loaded, pose_loaded = load_slam_state(str(root / "boundary.npz"), device=dev)
        m2, p2 = slam_sequence_managed(colors[:, t_c:], depths[:, t_c:], K, None, opts,
                                       resume_from=(m_loaded, pose_loaded), **kw)
        same = (torch.equal(m2.data, m.data), torch.equal(m2.num_points, m.num_points), torch.equal(p2, poses[:, t_c:]))
        ply = root / "map.ply"
        pointclouds_to_ply(map_to_pointclouds(m), str(ply), 0)
        n_ply = _ply_vertices(ply)
        _log(f"files resume at frame {t_c} from {(root / 'boundary.npz').stat().st_size} bytes: map, counts, poses "
             f"bitwise equal to the uninterrupted run {same}; PLY of entry 0: {n_ply} vertices, "
             f"{ply.stat().st_size} bytes")
        _check(all(same), f"files: the resumed run differs from the uninterrupted one {same}")
        _check(n_ply == int(m.num_points[0]), f"files: PLY {n_ply} vertices, map {int(m.num_points[0])}")

        src, tgt, valid, _ = rec.knns[len(rec.knns) // 2]
        refresh = next(args for where, args, _ in rec.winners if where == "lifecycle")
        timings = {
            "knn": {f"files tum {H}x{W} main path": _time_knn_call("files tum main path", src, tgt, valid)},
            "winner": {f"refresh at CAP={capacity_hw}*H*W {H}x{W}": _time_winner_call("refresh", refresh[:4], *refresh[4:])},
        }
    return launches, timings


def managed_scannet_phase(dev, capacity_hw=SCANNET_CAPACITY_HW, voxel_size=SCANNET_VOXEL):
    """Phase 16: phase 4's 240x320 data cycled to L=32, managed in an arena
    of 2*H*W rows against the unmanaged run at L*H*W: translations within
    5e-3 m (the JAX package's bound, tests/slam/test_lifecycle.py), at least
    one compaction, every selection bit-equal; the voxel merge's time at
    this capacity. Returns the managed run's launches."""
    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.slam import slam_sequence
    from gradslam_tpu_torch.structures import voxel_compact_map

    colors, depths, K = _scannet_clip(32)
    B, L, H, W = colors.shape[:4]
    rgb, depth, Kt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K))
    opts = PointFusion(device=dev).opts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_ref, p_ref = slam_sequence(rgb, depth, Kt, None, opts, L * H * W)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    cap = int(capacity_hw * H * W)
    m, poses, seconds, launches, rec = _managed_run(dev, rgb, depth, Kt, opts, capacity=cap, voxel_size=voxel_size)
    terr = float(torch.linalg.norm(poses[..., :3, 3] - p_ref[..., :3, 3], dim=-1).max())
    checked = rec.check("managed scannet")
    n_comp = len(rec.compactions)
    merge_ms, cells = None, None
    if n_comp:
        arena = rec.compactions[0][2]
        merge_ms = _time_ms(lambda: voxel_compact_map(arena, voxel_size), reps=5, warmup=1)
        cells = _check_voxel_cells("managed scannet", arena, (voxel_size,))
    _log(f"managed scannet B={B} L={L} {H}x{W} CAP={cap} voxel {voxel_size}: {B * L / seconds:.3f} frames/s "
         f"({seconds:.3f} s; unmanaged at CAP={L * H * W}: {B * L / ref_s:.3f}), {n_comp} compactions at frames "
         f"{[c[0] for c in rec.compactions]} ({[round(c[1], 3) for c in rec.compactions]} ms with the refresh, live "
         f"{[c[2].num_points.tolist() for c in rec.compactions]} before, {[c[3].tolist() for c in rec.compactions]} "
         f"after), num_points {m.num_points.tolist()} "
         f"(unmanaged {m_ref.num_points.tolist()}), voxel merge at CAP={cap}: {merge_ms} ms, max translation "
         f"from the unmanaged run {terr} m, launches {launches}; {checked}; {cells}")
    _check(n_comp >= 1, "managed scannet: no compaction")
    _check(terr < 5e-3, f"managed scannet: translations {terr} m from the unmanaged run")
    _check_launches("managed scannet", launches, {"knn": (L - 1) * 40, "winner": L + n_comp})
    return launches


def compacted_grad_phase(dev, voxel_size=GRAD_VOXEL):
    """Phase 17: the gradient of the pose loss with respect to the depth
    maps through ``slam_sequence_compacted`` (golden clip, B=2, L=6,
    ``PointFusion()`` defaults, an arena of 2*H*W rows merged at GRAD_VOXEL
    every 2 frames) on the card against the CPU: within 1e-3 of the CPU's largest
    value, nonzero on every frame after the first. Returns the card's
    forward launches."""
    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.slam import slam_sequence_compacted

    colors, depths, K = _golden_clip(6)
    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    out = []
    for d in (dev, torch.device("cpu")):
        rgb, depth, Kt = (torch.from_numpy(x).to(d) for x in (colors, depths, K))
        depth.requires_grad_(True)
        sync = torch.cuda.synchronize if d.type == "cuda" else (lambda: None)
        sync()
        _reset_launches()
        t0 = time.perf_counter()
        _, poses, peak = slam_sequence_compacted(rgb, depth, Kt, None, opts, 2 * H * W, segment_len=2,
                                                 voxel_size=voxel_size)
        loss = (poses[..., :3, 3] ** 2).sum()
        float(loss.detach())
        t1 = time.perf_counter()
        fwd = _launches()
        _reset_launches()
        loss.backward()
        sync()
        out.append((depth.grad, (t1 - t0, time.perf_counter() - t1), (fwd, _launches()), int(peak)))
    (g, secs, (fwd, bwd), peak), (g_cpu, secs_cpu, _, peak_cpu) = out
    err = _rel_err(g, g_cpu)
    per_frame = g.abs().reshape(B, L, -1).sum(dim=(0, 2))
    _log(f"compacted grad golden B={B} L={L} {H}x{W} CAP={2 * H * W} segment 2 voxel {voxel_size}: peak live {peak} "
         f"(cpu {peak_cpu}), max |card - cpu| / max |cpu| {err}, per-frame |grad| {per_frame.tolist()}; card forward "
         f"{secs[0]:.3f} s backward {secs[1]:.3f} s, cpu {secs_cpu[0]:.3f} s {secs_cpu[1]:.3f} s; launches forward "
         f"{fwd} backward {bwd}")
    _check(bool(torch.isfinite(g).all()) and bool((per_frame[1:] > 0).all()), f"compacted grad: {per_frame.tolist()}")
    _check(err <= 1e-3, f"compacted grad: card vs cpu {err}")
    first = (L - 1) % 2 or min(2, L - 1)  # the frames before the first boundary
    n_comp = (L - 1 - first) // 2
    _check_launches("compacted grad forward", fwd, {"knn": (L - 1) * 40, "winner": L + n_comp})
    _check_launches("compacted grad backward", bwd, {"knn": 0, "winner": 0})
    return fwd


def _build_kernels():
    """Builds every kernel's source at once (one nvcc each) and loads them."""
    kernels = _kernels()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(lambda k: k.load(), kernels.values()))
    _log(f"built {', '.join(k.source for k in kernels.values())} in {time.perf_counter() - t0:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _log(smi)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    _build_kernels()

    entries = {"knn": knn_phase(dev), "winner": winner_phase(dev)}
    by_path = {}
    golden_poses, by_path["golden"] = golden_phase(dev)
    by_path["scannet"], scannet_poses, scannet_npts = scannet_phase(dev, golden_poses)
    H, W = 120, 160
    colors, depths, K = _golden_clip(10)
    by_path["projective golden"] = projective_phase(dev, "golden", colors, depths, K, 2 * H * W, 0.02, 2.0)
    H, W = 240, 320
    colors, depths, K = _scannet_clip(16)
    by_path["projective scannet"] = projective_phase(
        dev, "scannet", colors, depths, K, 3 * H * W, 0.01, active_capacity=(3 * H * W) // 2
    )
    grad_phase(dev)
    by_path["calib golden"] = calib_phase(dev)
    by_path["backward scannet"] = backward_scannet_phase(dev)
    trajectory_metrics_phase(dev, golden_poses)
    for name, clip in (("golden", _golden_clip(10)), ("scannet", _scannet_clip(16))):
        by_path[f"metrics {name}"], timings = reconstruction_metrics_phase(dev, name, *clip)
        entries["knn"]["other_shapes"].update(timings)
    by_path["gated scannet"], _ = gated_scannet_phase(dev, scannet_poses, scannet_npts)
    by_path["labels scannet"] = labels_phase(dev, "scannet")
    by_path["labels projective scannet"] = labels_phase(
        dev, "projective scannet", assoc="projective", assoc_window=3 * H * W, active_capacity=(3 * H * W) // 2
    )
    by_path["object api"] = object_api_phase(dev)
    by_path["files tum 480x640"], timings = files_phase(dev)
    for name, t in timings.items():
        entries[name]["other_shapes"].update(t)
    by_path["managed scannet"] = managed_scannet_phase(dev)
    by_path["compacted grad golden"] = compacted_grad_phase(dev)
    for name, entry in entries.items():
        # launches: the ScanNet geometry's run of the path each kernel is
        # timed for; every path's count beside it
        entry["launches"] = by_path["scannet" if name == "knn" else "projective scannet"][name]
        entry["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
    _log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    _log(f"{smi}")
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
