"""Training steps back to back: ``slam_loss`` (the depth-calibration loss
through the configuration's SLAM run) differentiated with respect to
``DepthCalibParams`` and an SGD step on both parameters, as one
``GradStep`` (one captured CUDA graph of forward, loss, backward and
update), with the loss read to the host as a training loop logs it.

The sensor reads depth / ``true_scale``. The set-up renders ``distinct``
clips of ``batch`` arcs of ``frames`` frames with their ground-truth
poses and builds the parameters (scale 1, bias 0) and the step. Two calls
on the last two clips warm the step's graph up and capture it; their
updates are dropped, so the parameters stay where they started. The set-up
then drives the same object through its first three steps on clips 0, 1
and 2, each a replay of the captured graph: the reference follows those
three from the same start. The window hands the same object the next
clips in turn until ``seconds`` have passed and ends with the last step:
``train_step_s`` is the window's wall time over its steps.
"""

from __future__ import annotations

import contextlib
import time

import torch

from slam_bench import common, trace
from slam_bench.compare import leaf_gap, median, relative_gap

LEAVES = ("scale", "bias")
CHECKED_STEPS = 3


class State:
    pass


def _sgd(lr):
    from gradslam_tpu_torch.parallel import slam_loss

    def step(params, rgb, depth, K, gt, opts, capacity):
        loss = slam_loss(params, rgb, depth, K, gt, opts, capacity)
        g = torch.autograd.grad(loss, [params.scale, params.bias])
        with torch.no_grad():
            return params.scale - lr * g[0], params.bias - lr * g[1], loss.detach()

    return step


def setup(run) -> State:
    from gradslam_tpu_torch import GradStep
    from gradslam_tpu_torch.parallel import DepthCalibParams

    t0 = time.perf_counter()
    tr = run.workload["traffic"]
    st = State()
    st.run, st.B, st.L = run, tr["batch"], tr["frames"]
    colors, depths, K, gt = common.frames(run, tr["distinct"] * st.B, st.L)
    depths = depths / tr["true_scale"]
    st.clips = [tuple(x[i * st.B:(i + 1) * st.B] for x in (colors, depths, K, gt)) for i in range(tr["distinct"])]
    st.lr = tr["lr"]
    st.capacity = st.L * run.config["height"] * run.config["width"]
    st.opts = common.system(run.config, run.device).opts
    st.params = DepthCalibParams(scale=tr["init_scale"], bias=0.0, device=run.device)
    st.train = GradStep(_sgd(st.lr))
    st.history = [_values(st.params)]  # the parameters before each step, then after the last
    st.losses = []
    st.n = 0
    common.sync(run.device)
    t_inputs = time.perf_counter()
    for c in st.clips[-2:]:  # the graph's warm-up and capture, their updates dropped
        float(st.train(st.params, *c, st.opts, st.capacity)[2])
    for _ in range(CHECKED_STEPS):
        st.losses.append(_one(st))
        st.history.append(_values(st.params))
    print(f"set-up: inputs {t_inputs - t0:.3f} s, warm-up, capture and {CHECKED_STEPS} steps "
          f"{time.perf_counter() - t_inputs:.3f} s", flush=True)
    return st


def _values(params):
    return {k: float(getattr(params, k).detach()) for k in LEAVES}


def _one(st) -> float:
    c = st.clips[st.n % len(st.clips)]
    with torch.profiler.record_function("bench.train_step"):
        scale, bias, loss = st.train(st.params, *c, st.opts, st.capacity)
        with torch.no_grad():
            st.params.scale.copy_(scale)
            st.params.bias.copy_(bias)
        value = float(loss)
    st.n += 1
    return value


def window(st, seconds: float):
    n, t0, ends = 0, time.perf_counter(), []
    while n < 1 or time.perf_counter() - t0 < seconds:
        _one(st)
        ends.append(time.perf_counter())
        n += 1
    wall = ends[-1] - t0
    each = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"window: {n} training steps in {wall:.6f} s, each {each[0]:.6f}-{each[-1]:.6f} s (median "
          f"{each[len(each) // 2]:.6f}); scale {st.params.scale.item()!r} bias {st.params.bias.item()!r}", flush=True)
    return {"train_step_s": wall / n}, n


def traced(st):
    """One step profiled: the device's operations and the host's calls, and
    the wall time of the same work."""
    with common.profile(st.run.device) as prof:
        t0 = time.perf_counter()
        _one(st)
        wall = time.perf_counter() - t0
    record = trace.collect(prof)
    record.update(driver="train_step", frames=st.B * st.L, frame_steps=st.L, steps=1, wall_profiled_s=wall)
    return record, 1


def release(st):
    from gradslam_tpu_torch import clear_graphs

    st.train = st.params = None
    clear_graphs()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def outputs(st):
    """The losses and parameters of the port's first steps."""
    return st.losses, st.history


def reference(st, lowered=False, batch=None):
    """The reference's losses and parameters over the first steps from the
    same start (``lowered``: the TF32 control; ``batch``
    keeps only the first that many sequences of each clip, the fault of a
    step that leaves half of the batch out)."""
    from slam_bench import reference as ref

    with ref.precision.tf32_products() if lowered else contextlib.nullcontext():
        return _reference_steps(st, batch)


def _reference_steps(st, batch):
    from slam_bench import reference as ref

    opts = common.reference_options(st.run.config)
    p = {k: torch.tensor(v, dtype=torch.float32, device=st.run.device) for k, v in st.history[0].items()}
    losses, history = [], [dict(st.history[0])]
    for i in range(CHECKED_STEPS):
        rgb, depth, K, gt = (x[:batch] for x in st.clips[i % len(st.clips)])
        scale, bias = (p[k].clone().requires_grad_(True) for k in LEAVES)
        poses, _ = ref.sequence(rgb, depth * scale + bias * (depth > 0), K, opts, st.capacity)
        loss = ((poses[..., :3, 3] - gt[..., :3, 3]) ** 2).mean()
        g = torch.autograd.grad(loss, [scale, bias])
        with torch.no_grad():
            p = {"scale": scale - st.lr * g[0], "bias": bias - st.lr * g[1]}
        losses.append(float(loss.detach()))
        history.append({k: float(v) for k, v in p.items()})
    return losses, history


def gaps(st, out, ref) -> dict:
    """The compared numbers of the program's first steps against the
    reference's: each step's loss, the first gradient as the optimizer got
    it (the first update over the learning rate, on both sides, so both
    carry the update's rounding) and the parameters' change over the three
    steps, each leaf signed. A leaf whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) is left out of the
    gradient and change gaps."""
    prog_losses, h = out[:2]
    losses, history = ref
    lr = st.lr
    grads = {k: (h[0][k] - h[1][k]) / lr for k in LEAVES}
    ref_grads = {k: (history[0][k] - history[1][k]) / lr for k in LEAVES}
    med = median(abs(v) for v in ref_grads.values())
    skip = {k for k, v in ref_grads.items() if abs(v) < 1e-3 * med}
    change = {k: h[CHECKED_STEPS][k] - h[0][k] for k in LEAVES}
    ref_change = {k: history[CHECKED_STEPS][k] - history[0][k] for k in LEAVES}
    return {
        "loss_gap": max(relative_gap(a, b) for a, b in zip(prog_losses, losses)),
        "grad_gap": leaf_gap(grads, ref_grads, skip),
        "change_gap": leaf_gap(change, ref_change, skip),
    }


def check(st):
    return gaps(st, outputs(st), reference(st))
