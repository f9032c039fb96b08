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
reported) and once under ``torch.profiler``. On the card the frame step
runs as a captured CUDA graph (``gradslam_tpu_torch/slam/stepgraph.py``);
with ``--eager`` each point also runs under ``disable_graphs()``, op by op,
in turns with the graphed runs (eager, graphed, ..., each warmed up first).
For each it reports the wall time per frame step without and with the
profiler, the device time summed over kernels, the device's busy and idle
share of the wall time, device kernels per frame step, the host's launch
calls per frame step (``cudaLaunchKernel*``, ``cuLaunchKernel*`` and
``cudaGraphLaunch``) and its copy and memset calls, the share of device
time in scan kernels (the cumsums of ``ops.masking.compact_masked`` and of
the appends), and the kernels that take the most device time. ``--only``
keeps the points whose
name contains one of its comma-separated words. With
``--backward`` it also profiles the backward of a training step, the
gradient of ``slam_loss`` (the depth-calibration loss through
``PointFusion()``'s run) on the golden clip and at the ScanNet geometry:
the forward runs unprofiled, then ``loss.backward()`` is timed and
profiled the same way; and the whole training step,
``value_and_grad(slam_loss)`` (forward, loss and backward: one captured
CUDA graph on the card), graphed and op by op in turns, with the graph's
capture seconds, the peak memory of its first two calls (warm-up, capture),
the memory it keeps after they return and what ``clear_graphs()`` frees.
With ``--closure`` it profiles loop closure and the refiners the same way,
graphed (``slam/stepgraph.graphed``) and op by op in turns, per call:
cell 10's ``close_loops_rgbd(detection='both')`` (the loop of
``chip_smoke.py`` phase 19, 100 frames ray-cast at 480x640, closed from
``ICPSLAM(odom_targets='recent')``'s trajectory), ``pose_graph_refine`` at
L=256 (10 iterations), ``ba_refine`` with both solvers at phase 21's
smallest and largest problems (8 iterations) and
``examples_torch/train_loopclosure_ate.py``'s training step (one
``GradStep`` graph); ``--only`` keeps those whose name has one of its
words too. With ``--out`` it also writes the full table as JSON there.
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
# host calls of the CUDA runtime (cuda*) and its low-level API (cu*) that start device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def profile_point(name, colors, depths, K, dev, reps=1, top=15, eager=False, **options):
    """One point graphed and, with ``eager``, op by op, in turns; returns
    its reports."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from gradslam_tpu_torch import PointFusion, RGBDImages, disable_graphs

    rgbd = RGBDImages(colors, depths, K, device=dev)
    slam = PointFusion(device=dev, **options)
    modes = ("eager", "graphed") if eager else ("graphed",)
    mode = lambda m: disable_graphs() if m == "eager" else contextlib.nullcontext()
    for m in modes:
        with mode(m):
            slam(rgbd)  # warm-up: the kernels' build, the graph's capture
    torch.cuda.synchronize()
    walls = {m: [] for m in modes}
    for _ in range(reps):
        for m in modes:
            with mode(m):
                t0 = time.perf_counter()
                slam(rgbd)
                torch.cuda.synchronize()
            walls[m].append(time.perf_counter() - t0)
    out = []
    for m in modes:
        with mode(m), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            slam(rgbd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append(_report(f"{name} [{m}]", prof, wall, walls[m], colors.shape[:2], top))
    return out


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


def profile_train_step(name, colors, depths, K, gt, dev, reps=1, top=15):
    """A whole training step, ``value_and_grad(slam_loss)`` with respect to
    the calibration parameters, op by op and through its captured graph
    (:func:`profile_graphed`)."""
    from gradslam_tpu_torch import PointFusion, value_and_grad
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss

    B, L, H, W = colors.shape[:4]
    opts = PointFusion(device=dev).opts
    rgb, depth, Kt, gt = (torch.from_numpy(x).to(dev) for x in (colors, depths, K, gt))
    params = DepthCalibParams(device=dev)
    vg = value_and_grad(slam_loss)
    return profile_graphed(f"train step {name}", lambda: vg(params, rgb, depth, Kt, gt, opts, L * H * W),
                           lambda: vg.graphs.graphs, (B, L), reps, top)


def profile_graphed(name, step, graphs, batch_frames, reps=1, top=15):
    """``step()`` op by op (``disable_graphs()``) and through its captured
    graph, the one graph of the cache ``graphs()`` returns: each warmed up,
    ``reps`` timed runs in turns and one profiled run of each; returns the
    two reports, the graphed one with the graph's capture seconds, the peak
    memory of its first two calls (warm-up, capture), the memory it keeps
    after they return and what ``clear_graphs()`` frees."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from gradslam_tpu_torch import clear_graphs, disable_graphs

    mode = lambda m: disable_graphs() if m == "eager" else contextlib.nullcontext()
    clear_graphs()
    with disable_graphs():
        step()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step()  # the graph's warm-up, op by op on its side stream
    step()  # its capture and first replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (graph,) = graphs().values()
    memory = dict(capture_s=graph.capture_s, first_two_calls_s=first_s,
                  peak_bytes=torch.cuda.max_memory_allocated() - before,
                  kept_bytes=torch.cuda.memory_allocated() - before)
    del graph
    walls = {m: [] for m in ("eager", "graphed")}
    for _ in range(reps):
        for m in walls:
            with mode(m):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
            walls[m].append(time.perf_counter() - t0)
    out = []
    for m in walls:
        with mode(m), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append(_report(f"{name} [{m}]", prof, wall, walls[m], batch_frames, top))
    torch.cuda.empty_cache()
    held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    clear_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    memory.update(cleared_allocated_bytes=held - torch.cuda.memory_allocated(),
                  cleared_reserved_bytes=reserved - torch.cuda.memory_reserved())
    out[1].update(memory)
    print(f"  {name} graph: {memory}", flush=True)
    return out


def closure_points(dev, chip_smoke, keep):
    """(name, call, its graph cache's dict) of each loop-closure and
    refinement point (``--closure``) whose name ``keep`` accepts."""
    from gradslam_tpu_torch import GradStep, ICPSLAM, RGBDImages
    from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine
    from gradslam_tpu_torch.slam import close_loops_rgbd, stepgraph

    closures = lambda: stepgraph._CLOSURES.graphs
    points = []
    H, W = chip_smoke.E2E_HW
    name = f"close_loops_rgbd both cell 10 L={chip_smoke.LOOP_FRAMES} {H}x{W}"
    if keep(name):
        colors, depths, K, _ = chip_smoke._render_loop_card(dev, chip_smoke.LOOP_FRAMES, H, W, 0.55, 0.002)
        rgbd = RGBDImages(colors, depths, K, device=dev)
        _, plain = ICPSLAM(odom_targets="recent", device=dev)(rgbd)
        rgb, depth, Kt = rgbd.rgb_image, rgbd.depth_image, rgbd.intrinsics
        points.append((name, lambda: close_loops_rgbd(rgb, depth, Kt, plain, detection="both",
                                                      **chip_smoke.LOOP_GATES), closures))
    g = PoseGraph(*(x.to(dev) for x in chip_smoke._pose_graph_problem()[0]))
    name = f"pose_graph_refine L={g.poses.shape[0]} 10 iterations"
    if keep(name):
        points.append((name, lambda: pose_graph_refine(g, num_iters=10), closures))
    for L, M in chip_smoke.SHARDED_BA:
        args = tuple(torch.from_numpy(x).to(dev) for x in chip_smoke._ba_problem(L, M))
        for solver in ("dense", "pcg"):
            kw = dict(num_iters=8, max_obs_per_landmark=chip_smoke.BA_OBS_PER_LM, solver=solver)
            name = f"ba_refine {solver} L={L} M={M} 8 iterations"
            if keep(name):
                points.append((name, lambda args=args, kw=kw: ba_refine(*args, **kw), closures))
    name = "train_loopclosure_ate step L=13 N=256"
    if keep(name):
        ex = chip_smoke._example("train_loopclosure_ate")
        problem = ex.make_problem(13, 256, 0.02, 1.15, 0, dev)
        step = GradStep(ex.sgd)
        lr, log_s = torch.full((), 0.4, device=dev), torch.zeros((), device=dev)
        points.append((name, lambda: step(log_s, lr, *problem), lambda: step.graphs.graphs))
    return points


def _host_calls(prof, names):
    """Host calls of the CUDA runtime or its low-level API whose names start with one
    of ``names``, by name."""
    calls = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(names):
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


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
    launch_calls, copy_calls = _host_calls(prof, LAUNCH_CALLS), _host_calls(prof, COPY_CALLS)
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
        host_launch_calls=launch_calls,
        host_launch_calls_per_step=sum(launch_calls.values()) / L,
        host_copy_calls=copy_calls,
        host_copy_calls_per_step=sum(copy_calls.values()) / L,
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
          f"{out['launches_per_step']:.1f} device kernels per step, {out['host_launch_calls_per_step']:.2f} host "
          f"launch calls per step {launch_calls}, {out['host_copy_calls_per_step']:.2f} copy and memset calls "
          f"per step, device kernels "
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
                    help="also profile the backward of a training step and the whole step, graphed and "
                         "op by op, at both geometries")
    ap.add_argument("--only", help="comma-separated words: profile only the points whose name has one")
    ap.add_argument("--eager", action="store_true",
                    help="also run each point op by op (disable_graphs()), in turns with the graphed runs")
    ap.add_argument("--closure", action="store_true",
                    help="also profile loop closure (cell 10), the refiners and the loop-closure training step, "
                         "graphed and op by op, per call")
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
            res["points"] += profile_point(name, *clip, dev, args.reps, eager=args.eager, **options)
    if args.backward:
        for name, (colors, depths, K), L in (("golden B=2 L=10 120x160", chip_smoke._golden_clip(10), 10),
                                            ("scannet B=2 L=16 240x320", chip_smoke._scannet_clip(16), 16)):
            res["points"].append(profile_backward(
                f"backward {name}", colors, depths / chip_smoke.TRUE_SCALE, K, chip_smoke._cycled_poses(L),
                dev, args.reps,
            ))
            res["points"] += profile_train_step(
                name, colors, depths / chip_smoke.TRUE_SCALE, K, chip_smoke._cycled_poses(L), dev, args.reps)
    if args.closure:
        keep = lambda name: words is None or any(w in name for w in words)
        for name, call, graphs in closure_points(dev, chip_smoke, keep):
            res["points"] += profile_graphed(name, call, graphs, (1, 1), args.reps)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
