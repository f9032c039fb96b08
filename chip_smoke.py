"""Smoke run of gradslam_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``gradslam_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, then
drives the port's main path (``PointFusion()`` with gradICP odometry, KNN
association, exact full-arena fusion) through its public API:

  1. the card's name and power limit, and the kernel build;
  2. the KNN kernel against the plain version and a float64 oracle at the
     main path's shapes and at edge cases, with its time, the plain
     version's, ``torch.cdist``'s as a yardstick, and its bound;
  3. the golden clip (B=2, L=10, 120x160) against the reference goldens;
  4. the ScanNet geometry (B=2, L=16, 240x320, a 1.23M-row arena).

Any failed check raises. The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

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


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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

    packed = prepare_targets(tgt, valid).packed
    d_k, i_k = knn_kernel(src, packed)
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
    _log(f"knn {name}: src {tuple(src.shape)} tgt {tuple(tgt.shape)}: indices equal, "
         f"max |d - plain| {err_plain}, max |d - float64 oracle| {err_oracle}")
    return d_k, i_k, err_plain


def knn_phase(dev):
    """Kernel vs plain version at the main path's shapes and edge cases;
    returns the kernel's JSON entry (without ``launches``)."""
    from gradslam_tpu_torch.ops.knn import knn_kernel, knn_reference, prepare_targets

    gen = np.random.default_rng(0)

    def cloud(B, N):
        return torch.from_numpy(gen.uniform(-2, 2, (B, N, 3)).astype(np.float32)).to(dev)

    def validity(B, T, frac):
        return torch.from_numpy(gen.random((B, T)) >= frac).to(dev)

    errs = []
    shapes = {}
    for name, B, S, T in (("golden", 2, 1200, 5120), ("scannet", 2, 4800, 19456)):
        src, tgt, val = cloud(B, S), cloud(B, T), validity(B, T, 0.3)
        errs.append(_knn_case(f"{name} B={B} S={S} T={T} 30% invalid", src, tgt, val)[2])
        shapes[name] = (src, tgt, val)
    src, tgt = cloud(2, 321), cloud(2, 777)
    errs.append(_knn_case("unpadded 321x777", src, tgt, validity(2, 777, 0.0))[2])
    d, i, _ = _knn_case("all invalid", src, tgt, validity(2, 777, 1.01), oracle=False)
    _check(bool(torch.isinf(d).all()) and int(i.abs().max()) == 0, "knn all invalid: not (inf, 0)")
    # ties: every target twice, so each source has two nearest at equal distance
    tgt_dup = torch.cat([tgt, tgt], dim=1)
    d, i, _ = _knn_case("duplicate-target ties", src, tgt_dup, validity(2, 2 * 777, 0.0))
    _check(int(i.max()) < 777, "knn ties: a duplicate's higher index won")

    # timing at the main path's shapes
    timings = {}
    for name, (src, tgt, val) in shapes.items():
        packed = prepare_targets(tgt, val).packed
        ms = _time_ms(lambda: knn_kernel(src, packed), reps=50)
        plain_ms = _time_ms(lambda: knn_reference(src, tgt, val), reps=5, warmup=1)
        library_ms = _time_ms(
            lambda: torch.cdist(src, tgt, compute_mode="donot_use_mm_for_euclid_dist").min(-1),
            reps=10,
        )
        B, S, _ = src.shape
        T = tgt.shape[1]
        # each source against the valid targets of its own batch entry:
        # val.sum() already runs over the batch
        pairs = S * int(val.sum())
        nbytes = B * S * 3 * 4 + B * T * 4 * 4 + B * S * (4 + 4)
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = pairs * KNN_OPS_PER_PAIR / FP32_OPS_PER_S
        bound_ms = 1e3 * max(bytes_s, ops_s)
        bound_by = "bytes" if bytes_s > ops_s else "operations"
        timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        _log(f"knn timing {name} B={B} S={S} T={T}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
             f"cdist {library_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    entry = dict(
        name="knn",
        route="cuda",
        source="gradslam_tpu_torch/csrc/knn.cu",
        replaces="gradslam_tpu/ops/knn.py:75",
        max_abs_err=max(errs),
        **timings["scannet"],
        shape="B=2 S=4800 T=19456",
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


def _run_pointfusion(colors, depths, K, dev):
    """``PointFusion()(RGBDImages(...))`` timed by the host clock around a
    synchronized run; returns (pointclouds, poses, seconds, launches)."""
    from gradslam_tpu_torch import PointFusion, RGBDImages
    from gradslam_tpu_torch.ops.knn import knn_kernel

    rgbd = RGBDImages(colors, depths, K, device=dev)
    slam = PointFusion(device=dev)
    torch.cuda.synchronize()
    knn_kernel.launches = 0
    t0 = time.perf_counter()
    pcs, poses = slam(rgbd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return pcs, poses, seconds, knn_kernel.launches


def golden_phase(dev):
    """PointFusion gradicp on the golden clip against the reference goldens."""
    B, L, H, W = 2, 10, 120, 160
    colors, depths, K = _golden_clip(L)
    _run_pointfusion(colors[:, :2], depths[:, :2], K, dev)  # warm-up: load the kernel
    pcs, poses, seconds, launches = _run_pointfusion(colors, depths, K, dev)
    g = np.load(DATA / "reference_goldens" / "pointfusion_gradicp.npz")
    p = poses.cpu().numpy()
    npts = pcs.num_points_per_pointcloud.cpu().numpy()
    pose_err = float(np.abs(p - g["poses"]).max())
    _log(f"golden B={B} L={L} {H}x{W}: {B * L / seconds:.3f} frames/s ({seconds:.3f} s), "
         f"max |pose - golden| {pose_err}, num_points {npts.tolist()} vs golden "
         f"{g['num_points'].tolist()}, knn launches {launches}")
    _check(pose_err < 2e-3, f"golden poses off by {pose_err}")
    _check(bool(np.all(np.abs(npts - g["num_points"]) <= 0.05 * g["num_points"])),
           f"golden num_points {npts} vs {g['num_points']}")
    _check(launches == (L - 1) * 40, f"golden run launched the knn kernel {launches} times")
    return p, launches


def scannet_phase(dev, golden_poses):
    """PointFusion gradicp at the repo's ScanNet geometry (240x320, L=16)."""
    B, L, H, W = 2, 16, 240, 320
    colors, depths, K = _golden_clip(L)
    colors, depths = _bilinear2x(colors), _bilinear2x(depths)
    K = K.copy()
    K[:, :, :2] *= 2.0  # fx, fy, cx, cy scale with the upsample
    torch.cuda.reset_peak_memory_stats()
    pcs, poses, seconds, launches = _run_pointfusion(colors, depths, K, dev)
    p = poses.cpu().numpy()
    npts = pcs.num_points_per_pointcloud.cpu().numpy()
    n_gold = golden_poses.shape[1]
    drift = float(np.abs(p[:, :n_gold] - golden_poses).max())
    _log(f"scannet B={B} L={L} {H}x{W} CAP={L * H * W}: {B * L / seconds:.3f} frames/s "
         f"({seconds:.3f} s), peak memory {torch.cuda.max_memory_allocated()} bytes, "
         f"num_points {npts.tolist()}, max |pose - golden-clip pose| {drift}, "
         f"knn launches {launches}")
    _check(bool(np.isfinite(p).all()), "scannet poses are not finite")
    _check(launches == (L - 1) * 40, f"scannet run launched the knn kernel {launches} times")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gradslam_tpu_torch.ops.knn import knn_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _log(smi)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    knn_kernel.load()  # builds csrc/knn.cu with nvcc
    _log(f"built {knn_kernel.source} in {time.perf_counter() - t0:.3f} s")

    entry = knn_phase(dev)
    golden_poses, _ = golden_phase(dev)
    entry["launches"] = scannet_phase(dev, golden_poses)
    print(json.dumps({"kernels": [entry]}))
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
