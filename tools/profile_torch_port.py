"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python tools/profile_torch_port.py [--out profile.json]

Runs ``PointFusion()`` (gradICP odometry, KNN association, exact fusion) on
the golden clip (B=2, L=10, 120x160) and at the ScanNet geometry (B=2,
L=16, 240x320, the golden clip upsampled 2x as chip_smoke.py does), and
``PointFusion(assoc='projective', ...)`` at both (window 2*H*W on the
golden clip; window 3*H*W and active buffer 1.5*H*W at the ScanNet
geometry, as chip_smoke.py runs them), and ``PointFusion(block_size=4096)``
at the ScanNet geometry (block gating: association over the visible blocks
only), each once to warm up, ``--reps`` times timed (the median is
reported) and once under ``torch.profiler``. For each it reports the wall
time per frame step without and with the profiler, the device time summed
over kernels, the device's busy and idle share of the wall time, kernel
launches per frame step, the share of device time in scan kernels (the
cumsums of ``ops.masking.compact_masked`` and of the appends), and the
kernels that take the most device time. ``--only`` keeps the points whose
name contains one of its comma-separated words. With
``--backward`` it also profiles the backward of a training step, the
gradient of ``slam_loss`` (the depth-calibration loss through
``PointFusion()``'s run) on the golden clip and at the ScanNet geometry:
the forward runs unprofiled, then ``loss.backward()`` is timed and
profiled the same way. With ``--out`` it also writes the full table as JSON
there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# CUDA functions of each hand-written kernel (csrc/*.cu)
PORT_KERNELS = {"knn": ("knn_cluster",), "winner": ("winner_grid",)}


def profile_point(name, colors, depths, K, dev, reps=1, top=15, **options):
    from torch.profiler import ProfilerActivity, profile

    from gradslam_tpu_torch import PointFusion, RGBDImages

    rgbd = RGBDImages(colors, depths, K, device=dev)
    slam = PointFusion(device=dev, **options)
    slam(rgbd)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        slam(rgbd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam(rgbd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _report(name, prof, wall, walls, colors.shape[:2], top)


def profile_backward(name, colors, depths, K, gt, dev, reps=1, top=15):
    """The backward of one training step: ``slam_loss`` runs unprofiled,
    then ``loss.backward()`` is timed (``reps`` times, each after a fresh
    forward) and profiled once."""
    from torch.profiler import ProfilerActivity, profile

    from gradslam_tpu_torch import PointFusion
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss

    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    rgb, depth, Kt, gt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K, gt))
    params = DepthCalibParams(device=dev)

    def forward():
        params.zero_grad()
        loss = slam_loss(params, rgb, depth, Kt, gt, opts, L * H * W)
        torch.cuda.synchronize()
        return loss

    forward().backward()  # warm-up
    walls = []
    for _ in range(reps):
        loss = forward()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    loss = forward()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _report(name, prof, wall, walls, (B, L), top)


def _report(name, prof, wall, walls, batch_frames, top):
    """The device's share of one profiled run and its kernels by name."""
    wall_plain = sorted(walls)[len(walls) // 2]
    B, L = batch_frames
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    # union of kernel intervals: time the device had at least one kernel
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    covered, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the port's hand-written kernels, by the names of their CUDA functions
    ours = {}
    for label, marks in PORT_KERNELS.items():
        hits = [v for k, v in by_name.items() if any(m in k for m in marks)]
        us = sum(v[1] for v in hits)
        ours[label] = dict(launches=sum(v[0] for v in hits), ms=us / 1e3,
                           share_of_device=us / busy_us if busy_us else 0.0)
    # the cumsums: CUDA scan kernels
    scans = [v for k, v in by_name.items() if "scan" in k.lower()]
    scan_us = sum(v[1] for v in scans)
    out = dict(
        point=name,
        frames=B * L,
        frame_steps=L,
        wall_s=wall,
        wall_unprofiled_s=wall_plain,
        wall_unprofiled_runs_s=walls,
        frames_per_s_unprofiled=B * L / wall_plain,
        frames_per_s=B * L / wall,
        wall_ms_per_step=1e3 * wall / L,
        kernel_launches=len(kernels),
        launches_per_step=len(kernels) / L,
        device_kernel_ms=busy_us / 1e3,
        device_busy_share=covered / 1e6 / wall,
        device_idle_share=1.0 - covered / 1e6 / wall,
        port_kernels=ours,
        scan_kernels=dict(launches=sum(v[0] for v in scans), ms=scan_us / 1e3,
                          share_of_device=scan_us / busy_us if busy_us else 0.0),
        top_kernels=[
            dict(name=k[:120], launches=c, ms=us / 1e3, share_of_device=us / busy_us if busy_us else 0.0)
            for k, (c, us) in rows[:top]
        ],
    )
    print(f"{name}: {out['frames_per_s_unprofiled']:.3f} frames/s unprofiled (median of "
          f"{len(walls)}: {[round(B * L / w, 3) for w in walls]}), "
          f"{out['frames_per_s']:.3f} profiled, {out['wall_ms_per_step']:.3f} ms per step, "
          f"{out['launches_per_step']:.1f} kernel launches per step, device kernels "
          f"{out['device_kernel_ms']:.3f} ms, device busy {out['device_busy_share']:.4f}, "
          f"idle {out['device_idle_share']:.4f}", flush=True)
    for label, r in ours.items():
        print(f"  port kernel {label}: {r['ms']:.4f} ms in {r['launches']} CUDA launches, "
              f"{r['share_of_device']:.4f} of device time")
    r = out["scan_kernels"]
    print(f"  scan kernels (cumsum): {r['ms']:.4f} ms in {r['launches']} launches, "
          f"{r['share_of_device']:.4f} of device time")
    for r in out["top_kernels"]:
        print(f"  {r['ms']:10.4f} ms {r['launches']:6d}x {r['share_of_device']:.4f}  {r['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON to this file")
    ap.add_argument("--reps", type=int, default=1, help="unprofiled timed runs per point")
    ap.add_argument("--backward", action="store_true",
                    help="also profile the backward of a training step at both geometries")
    ap.add_argument("--only", help="comma-separated words: profile only the points whose name has one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    res = {"card": smi, "torch": torch.__version__, "points": []}
    words = args.only.split(",") if args.only else None
    golden, scannet = chip_smoke._golden_clip(10), chip_smoke._scannet_clip(16)
    HW, HW4 = 120 * 160, 240 * 320
    for name, clip, options in (
        ("golden B=2 L=10 120x160", golden, {}),
        ("projective golden B=2 L=10 120x160", golden, dict(assoc="projective", assoc_window=2 * HW)),
        ("scannet B=2 L=16 240x320", scannet, {}),
        ("projective scannet B=2 L=16 240x320", scannet,
         dict(assoc="projective", assoc_window=3 * HW4, active_capacity=(3 * HW4) // 2)),
        ("gated scannet B=2 L=16 240x320 block 4096", scannet, dict(block_size=4096)),
    ):
        if words is None or any(w in name for w in words):
            res["points"].append(profile_point(name, *clip, dev, args.reps, **options))
    if args.backward:
        for name, (colors, depths, K), L in (("golden B=2 L=10 120x160", chip_smoke._golden_clip(10), 10),
                                            ("scannet B=2 L=16 240x320", chip_smoke._scannet_clip(16), 16)):
            res["points"].append(profile_backward(
                f"backward {name}", colors, depths / chip_smoke.TRUE_SCALE, K, chip_smoke._cycled_poses(L),
                dev, args.reps,
            ))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
