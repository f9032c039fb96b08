"""Whole sequences back to back: ``PointFusion(...)(RGBDImages(...))``.

A closed loop: each sequence's poses and map are synchronized before the
next one is handed in. The set-up renders ``distinct`` batches of
``batch`` arcs of ``frames`` frames and runs ``warm_runs`` sequences (the
first warms each captured graph up, the second captures it); the window
then runs whole sequences, in turn over the batches, until ``seconds``
have passed, and ends with the last one: ``frames_per_s`` is every frame
of every sequence over the window's wall time. The sequence whose outputs
are compared with the reference is drawn from the seed among the first two
of the window.
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
    st.frames = [RGBDImages(c, d, k, device=run.device) for c, d, k in st.inputs]
    common.sync(run.device)
    t_inputs = time.perf_counter()
    st.slam = common.system(run.config, run.device)
    warm = []
    for i in range(tr["warm_runs"]):
        st.slam(st.frames[i % len(st.frames)])
        common.sync(run.device)
        warm.append(round(time.perf_counter() - t_inputs - sum(warm), 3))
    print(f"set-up: inputs {t_inputs - t0:.3f} s, warm runs {warm} s", flush=True)
    st.sample = None
    return st


def _one(st, n):
    with torch.profiler.record_function("bench.sequence"):
        pcs, poses = st.slam(st.frames[n % len(st.frames)])
        common.sync(st.run.device)
    return pcs, poses


def window(st, seconds: float):
    keep = common.draw(st.run.seed, "sequence", 2)
    n, t0, ends = 0, time.perf_counter(), []
    while n < 2 or time.perf_counter() - t0 < seconds:
        out = _one(st, n)
        ends.append(time.perf_counter())
        if n == keep:
            st.sample = (n % len(st.frames), *out)
        n += 1
    wall = ends[-1] - t0
    each = [round(b - a, 6) for a, b in zip([t0] + ends, ends)]
    print(f"window: {n} sequences of {st.B}x{st.L} frames in {wall:.6f} s, each {each} s", flush=True)
    return {"frames_per_s": n * st.B * st.L / wall}, n


def traced(st):
    """One sequence profiled: the device's operations and the host's calls,
    and the wall time of the same work."""
    n = common.draw(st.run.seed, "sequence", len(st.frames))
    with common.profile(st.run.device) as prof:
        t0 = time.perf_counter()
        out = _one(st, n)
        wall = time.perf_counter() - t0
    st.sample = (n % len(st.frames), *out)
    record = trace.collect(prof)
    record.update(driver="sequence", frames=st.B * st.L, frame_steps=st.L, steps=1, wall_profiled_s=wall)
    return record, 1


def release(st):
    """Drops the port's system and its captured graphs before the reference runs."""
    from gradslam_tpu_torch import clear_graphs

    st.slam = st.frames = None
    clear_graphs()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def outputs(st):
    """The compared sequence's poses and map rows as the port produced them."""
    _, pcs, poses = st.sample
    data = torch.cat([pcs.points_padded, pcs.normals_padded, pcs.colors_padded, pcs.features_padded], dim=-1)
    return poses, arena_rows(data, pcs.num_points_per_pointcloud)


def reference(st, lowered=False):
    """The plain reference's poses and maps of the compared sequence, worked
    out again from its frames (``lowered``: the TF32 control)."""
    from slam_bench import reference as ref

    rgb, depth, K = st.inputs[st.sample[0]]
    capacity = st.L * rgb.shape[2] * rgb.shape[3]  # the port's arena: the whole sequence
    with torch.no_grad(), ref.precision.tf32_products() if lowered else contextlib.nullcontext():
        return ref.sequence(rgb, depth, K, common.reference_options(st.run.config), capacity)


def gaps(st, out, ref) -> dict:
    """The compared numbers: poses and map against the reference's."""
    return {**pose_gaps(out[0], ref[0]), **map_gaps(out[1], ref[1], st.run.seed)}


def check(st):
    return gaps(st, outputs(st), reference(st))
