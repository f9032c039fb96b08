"""Whole sequences with loop closure back to back:
``ICPSLAM(..., loop_closure=...)(RGBDImages(...))``, the sequence's
captured graph and then the closure's.

The window, the traced run and the release are :mod:`.sequence`'s; the
set-up builds ``ICPSLAM`` through its public constructor with the
configuration's options, and the reference is
:mod:`slam_bench.reference.icpslam_loop`. Compared: the refined pose of
every frame, the aggregate map, and the loop pairs that the port and the
reference accepted (``loop_pairs_gap``: the pairs that one accepted and the
other did not), so that a flipped acceptance is named, not only seen as a
pose gap.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import fields

import torch

from slam_bench import common
from slam_bench.compare import pose_gaps
from slam_bench.drivers import sequence

window, release = sequence.window, sequence.release


def setup(run) -> sequence.State:
    import gradslam_tpu_torch as port
    from gradslam_tpu_torch import RGBDImages

    t0 = time.perf_counter()
    tr = run.workload["traffic"]
    st = sequence.State()
    st.run, st.B, st.L = run, tr["batch"], tr["frames"]
    colors, depths, K, _ = common.frames(run, tr["distinct"] * st.B, st.L)
    st.inputs = [tuple(x[i * st.B:(i + 1) * st.B] for x in (colors, depths, K)) for i in range(tr["distinct"])]
    st.frames = [RGBDImages(c, d, k, device=run.device) for c, d, k in st.inputs]
    common.sync(run.device)
    t_inputs = time.perf_counter()
    st.slam = {"ICPSLAM": port.ICPSLAM}[run.config["system"]](device=run.device, **run.config["options"])
    warm = []
    for i in range(tr["warm_runs"]):
        st.slam(st.frames[i % len(st.frames)])
        common.sync(run.device)
        warm.append(round(time.perf_counter() - t_inputs - sum(warm), 3))
    print(f"set-up: inputs {t_inputs - t0:.3f} s, warm runs {warm} s", flush=True)
    st.sample = None
    return st


def traced(st):
    """One sequence and its closure profiled (:func:`.sequence.traced`)."""
    record, attempted = sequence.traced(st)
    record.update(driver="loop_sequence", sequences=1)
    return record, attempted


def reference_options(config: dict):
    """The reference's (:class:`Options`, :class:`Closure`) from the
    configuration's options by the same names."""
    from slam_bench.reference import Options
    from slam_bench.reference.icpslam_loop import Closure

    opts = config["options"]
    names = {f.name for f in fields(Options)}
    return (Options(**{k: v for k, v in opts.items() if k in names}),
            Closure(detection=opts["loop_closure"], **opts.get("loop_closure_kwargs", {})))


def port_pairs(run, rgb, depth, K):
    """The loop pairs the port accepts on a batch, each element's sorted
    [(i, j)], through its public functions: ``ICPSLAM`` without closure for
    the trajectory that the closure starts from, then the clouds and
    invariant descriptors that ``close_loops_rgbd`` builds by default and
    ``close_loops_batched`` on them. Also returns that closure's refined
    poses (B, L, 4, 4)."""
    import gradslam_tpu_torch as port
    from gradslam_tpu_torch import RGBDImages, clear_graphs
    from gradslam_tpu_torch.slam import loopclosure as lc

    opts = dict(run.config["options"])
    detection, kw = opts.pop("loop_closure"), dict(opts.pop("loop_closure_kwargs", {}))
    ds = kw.pop("dsratio", 4)
    frames = RGBDImages(rgb, depth, K, device=run.device).to_channels_last()
    with torch.no_grad():
        _, odometry = port.ICPSLAM(device=run.device, **opts)(frames)
        pts, nrm, val, _, _ = lc.frame_clouds_from_rgbd(frames.depth_image, frames.intrinsics, ds)
        descs = lc.keyframe_descriptors_invariant(pts, nrm, val)
        refined, cand, w = lc.close_loops_batched(odometry, pts, nrm, val, detection=detection, descriptors=descs,
                                                  **kw)
    pairs = [sorted((int(i), int(j)) for (i, j), ok, wt in zip(e.tolist(), v.tolist(), x.tolist()) if ok and wt > 0)
             for e, v, x in zip(cand.edges, cand.valid, w)]
    refined = refined.cpu()
    clear_graphs()
    return pairs, refined


def outputs(st):
    """The compared sequence's poses and map rows as the port produced them,
    and the loop pairs it accepts on that sequence (:func:`port_pairs`)."""
    poses, rows = sequence.outputs(st)
    pairs, refined = port_pairs(st.run, *st.inputs[st.sample[0]])
    print(f"port's loop pairs {pairs}; their closure again against the compared poses: "
          f"{pose_gaps(refined, poses.cpu())}", flush=True)
    return poses, rows, pairs


def reference(st, lowered=False):
    """The plain reference's refined poses, maps and accepted loop pairs of
    the compared sequence, worked out again from its frames (``lowered``:
    the TF32 control)."""
    from slam_bench import reference as ref
    from slam_bench.reference import icpslam_loop

    rgb, depth, K = st.inputs[st.sample[0]]
    with torch.no_grad(), ref.precision.tf32_products() if lowered else contextlib.nullcontext():
        poses, maps, pairs = icpslam_loop.sequence(rgb, depth, K, *reference_options(st.run.config))
    print(f"reference's loop pairs {pairs}", flush=True)
    return poses, maps, [[(int(i), int(j)) for i, j in p] for p in pairs]


def gaps(st, out, ref) -> dict:
    """The compared numbers: :func:`.sequence.gaps` of poses and map, and
    the count of loop pairs accepted by one of the two only."""
    flipped = sum(len(set(a) ^ set(b)) for a, b in zip(out[2], ref[2]))
    return {**sequence.gaps(st, out[:2], ref[:2]), "loop_pairs_gap": float(flipped)}


def check(st):
    return gaps(st, outputs(st), reference(st))
