"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python tools/profile_torch_port.py [--out profile.json]

Runs ``PointFusion()`` (gradICP odometry, KNN association, exact fusion) on
the golden clip (B=2, L=10, 120x160) and at the ScanNet geometry (B=2,
L=16, 240x320, the golden clip upsampled 2x as chip_smoke.py does), each
once to warm up, ``--reps`` times timed (the median is reported) and once
under ``torch.profiler``. For each it reports the wall time per frame step
without and with the profiler, the device time summed over kernels, the
device's busy and idle share of the wall time, kernel launches per frame
step, and the kernels that take the most device time. With ``--out`` it
also writes the full table as JSON there.
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


def profile_point(name, colors, depths, K, dev, reps=1, top=15):
    from torch.profiler import ProfilerActivity, profile

    from gradslam_tpu_torch import PointFusion, RGBDImages

    rgbd = RGBDImages(colors, depths, K, device=dev)
    slam = PointFusion(device=dev)
    slam(rgbd)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        slam(rgbd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_plain = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam(rgbd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    B, L = colors.shape[:2]
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
        top_kernels=[
            dict(name=k[:120], launches=c, ms=us / 1e3, share_of_device=us / busy_us if busy_us else 0.0)
            for k, (c, us) in rows[:top]
        ],
    )
    print(f"{name}: {out['frames_per_s_unprofiled']:.3f} frames/s unprofiled (median of "
          f"{reps}: {[round(B * L / w, 3) for w in walls]}), "
          f"{out['frames_per_s']:.3f} profiled, {out['wall_ms_per_step']:.3f} ms per step, "
          f"{out['launches_per_step']:.1f} kernel launches per step, device kernels "
          f"{out['device_kernel_ms']:.3f} ms, device busy {out['device_busy_share']:.4f}, "
          f"idle {out['device_idle_share']:.4f}", flush=True)
    for r in out["top_kernels"]:
        print(f"  {r['ms']:10.4f} ms {r['launches']:6d}x {r['share_of_device']:.4f}  {r['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON to this file")
    ap.add_argument("--reps", type=int, default=1, help="unprofiled timed runs per point")
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
    colors, depths, K = chip_smoke._golden_clip(10)
    res["points"].append(profile_point("golden B=2 L=10 120x160", colors, depths, K, dev, args.reps))
    colors, depths, K = chip_smoke._golden_clip(16)
    colors, depths = chip_smoke._bilinear2x(colors), chip_smoke._bilinear2x(depths)
    K = K.copy()
    K[:, :, :2] *= 2.0
    res["points"].append(profile_point("scannet B=2 L=16 240x320", colors, depths, K, dev, args.reps))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
