"""A robot's incremental run: sessions of ``frames`` frames, each started
by ``init_state`` on its first frame and advanced by ``step_state`` frame
by frame; each frame's pose is copied to the host before the next frame is
handed in (a closed loop: the robot waits for its pose).

The set-up renders ``distinct`` sessions of ``batch`` arcs and runs the
first ``warm_frames`` frames of one (a step's graph is warmed up at its
first call and captured at its second). The window runs sessions in turn,
frame by frame, until ``seconds`` have passed, and ends with the frame
then running: ``frame_latency_p95_ms`` is the 95th percentile over every
frame of the window, each session's first frame included, of the time
from handing the frame to the port to its pose on the host. The session
compared with the reference is drawn from the seed among the first two of
the window.
"""

from __future__ import annotations

import contextlib
import time

import torch

from slam_bench import common, trace
from slam_bench.compare import arena_rows, map_gaps, pose_gaps


class State:
    pass


def setup(run) -> State:
    from gradslam_tpu_torch import RGBDImages

    t0 = time.perf_counter()
    tr = run.workload["traffic"]
    st = State()
    st.run, st.B, st.L = run, tr["batch"], tr["frames"]
    colors, depths, K, _ = common.frames(run, tr["distinct"] * st.B, st.L)
    st.inputs = [tuple(x[i * st.B:(i + 1) * st.B] for x in (colors, depths, K)) for i in range(tr["distinct"])]
    st.frames = [[RGBDImages(c[:, t:t + 1], d[:, t:t + 1], k, device=run.device) for t in range(st.L)]
                 for c, d, k in st.inputs]
    common.sync(run.device)
    t_inputs = time.perf_counter()
    st.slam = common.system(run.config, run.device)
    state = None
    for t in range(tr["warm_frames"]):
        state, _ = _frame(st, state, 0, t)
    print(f"set-up: inputs {t_inputs - t0:.3f} s, warm frames {time.perf_counter() - t_inputs:.3f} s", flush=True)
    st.sample = None
    return st


def _frame(st, state, s, t):
    """Hands frame ``t`` of session ``s`` to the port; returns the new state
    and the pose on the host."""
    frame = st.frames[s % len(st.frames)][t]
    with torch.profiler.record_function("bench.frame"):
        state = st.slam.init_state(frame) if t == 0 else st.slam.step_state(state, frame)
        pose = state.pose.cpu()
    return state, pose


def _session(st, s, latencies=None, deadline=None):
    """Runs session ``s``; returns (its last state, its host poses) or None
    when the deadline ended it first."""
    state, poses = None, []
    for t in range(st.L):
        t0 = time.perf_counter()
        state, pose = _frame(st, state, s, t)
        t1 = time.perf_counter()
        poses.append(pose)
        if latencies is not None:
            latencies.append(t1 - t0)
        if deadline is not None and t1 >= deadline:
            return None
    return state, torch.stack(poses, dim=1)


def window(st, seconds: float):
    keep = common.draw(st.run.seed, "session", 2)
    latencies, s, t0 = [], 0, time.perf_counter()
    while True:
        done = _session(st, s, latencies, None if s < 2 else t0 + seconds)
        if s == keep:
            st.sample = (s % len(st.frames), *done)
        s += 1
        if s >= 2 and (done is None or time.perf_counter() - t0 >= seconds):
            break
    ms = sorted(1e3 * x for x in latencies)
    print(f"window: {len(ms)} frames in {s} sessions; latency p50 {ms[len(ms) // 2]!r} ms, p95 "
          f"{trace.p95(ms)!r} ms, max {ms[-1]!r} ms", flush=True)
    return {"frame_latency_p95_ms": trace.p95(ms)}, len(ms)


def traced(st):
    """One session profiled: the device's operations and the host's calls,
    and the wall time of the same work."""
    s = common.draw(st.run.seed, "session", len(st.frames))
    with common.profile(st.run.device) as prof:
        t0 = time.perf_counter()
        done = _session(st, s)
        wall = time.perf_counter() - t0
    st.sample = (s % len(st.frames), *done)
    record = trace.collect(prof)
    record.update(driver="online_step", frames=st.B * st.L, frame_steps=st.L, steps=1, wall_profiled_s=wall)
    return record, st.L


def release(st):
    from gradslam_tpu_torch import clear_graphs

    st.slam = st.frames = None
    clear_graphs()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def outputs(st):
    """The compared session's host poses and last arena as the port produced them."""
    _, state, poses = st.sample
    return poses, arena_rows(state.map_state.data, state.map_state.num_points)


def reference(st, lowered=False):
    """The plain reference's poses and map of the compared session, frame by
    frame from its first (``lowered``: the TF32 control)."""
    from slam_bench import reference as ref

    rgb, depth, K = st.inputs[st.sample[0]]
    capacity = 100 * rgb.shape[2] * rgb.shape[3]  # init_state's default arena
    with torch.no_grad(), ref.precision.tf32_products() if lowered else contextlib.nullcontext():
        return ref.sequence(rgb, depth, K, common.reference_options(st.run.config), capacity)


def gaps(st, out, ref) -> dict:
    """The compared numbers: poses and map against the reference's."""
    return {**pose_gaps(out[0], ref[0]), **map_gaps(out[1], ref[1], st.run.seed)}


def check(st):
    return gaps(st, outputs(st), reference(st))
