"""A run whose timed path is broken comes out not correct, and so does the
control. Each test skips the run's look for a card and drives the rest of
a run of a cell cut to a CPU test's size (``harness.execute``), with the
cell's own limits, after breaking the port underneath: a step that returns
its state unchanged, half of the batch left out (the cells with B = 2), an
answer altered where it is produced (a pose; the colours, normals or
confidences of the map). The control is the reference with its products in
TF32 put in the port's place."""

import json
import time

import pytest
import torch

from conftest import ROOT

from slam_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


def _run(cell, tiny, seed=11):
    wl, cfg = tiny(cell)
    driver = harness.load_module("drivers", wl["driver"])
    run = harness.Run(wl, cfg, seed, CPU, False)
    result, _ = harness.execute(BENCH, run, driver, {}, 0.0, time.perf_counter())
    return result


def _unchanged_step(monkeypatch):
    """The frame step returns the state it was given."""
    import gradslam_tpu_torch.slam.icpslam as icpslam

    monkeypatch.setattr(icpslam, "slam_step_state", lambda state, *a, **k: state)


def _half_batch_sequence(monkeypatch):
    """The batch's second half is left out: the first half's result stands in for it."""
    import gradslam_tpu_torch.slam.icpslam as icpslam

    real = icpslam.slam_sequence

    def half(rgb, depth, K, poses, opts, capacity, *a, **k):
        h = rgb.shape[0] // 2
        m, p = real(rgb[:h], depth[:h], K[:h], None if poses is None else poses[:h], opts, capacity, *a, **k)
        rep = lambda x: torch.cat([x] * 2)
        return icpslam.MapState(rep(m.data), rep(m.num_points)), rep(p)

    monkeypatch.setattr(icpslam, "slam_sequence", half)


def _altered_pose(monkeypatch):
    """Every pose moves by a centimetre (about a frame's motion) where it is produced."""
    import gradslam_tpu_torch.slam.icpslam as icpslam

    real = icpslam.slam_step_state

    def altered(*a, **k):
        s = real(*a, **k)
        pose = s.pose.clone()
        pose[:, 0, 3] += 1e-2
        return s._replace(pose=pose)

    monkeypatch.setattr(icpslam, "slam_step_state", altered)


def _altered_map(channels, change):
    """Each frame step alters the map's rows (their colours, normals or
    confidences: channels that odometry never reads) where it writes them."""
    import gradslam_tpu_torch.slam.icpslam as icpslam

    real = icpslam.slam_step_state

    def altered(*a, **k):
        s = real(*a, **k)
        data = s.map_state.data.clone()
        data[..., channels] = change(data[..., channels])
        return s._replace(map_state=icpslam.MapState(data, s.map_state.num_points))

    return lambda monkeypatch: monkeypatch.setattr(icpslam, "slam_step_state", altered)


SEQUENCE_FAULTS = {
    "unchanged_step": _unchanged_step,
    "altered_pose": _altered_pose,
    "altered_colors": _altered_map(slice(6, 9), lambda c: c + 8.0),  # 3% of the range
    "altered_normals": _altered_map(slice(3, 6), lambda n: n.roll(1, dims=-1)),
    "altered_confidence": _altered_map(slice(9, 10), lambda c: c * 2.0),
}


@pytest.mark.parametrize("fault", sorted(SEQUENCE_FAULTS) + ["half_batch"])
@pytest.mark.parametrize("cell", ["pf-scannet-seq64", "pf-scannet-online"])
def test_a_broken_frame_path_is_not_correct(cell, fault, tiny, monkeypatch):
    if fault == "half_batch":
        if tiny(cell)[0]["traffic"]["batch"] < 2:
            pytest.skip("B = 1: no half of the batch to leave out")
        _half_batch_sequence(monkeypatch)
    else:
        SEQUENCE_FAULTS[fault](monkeypatch)
    assert _run(cell, tiny)["correct"] is False


def _train_fault(fault, monkeypatch):
    import gradslam_tpu_torch.parallel as parallel
    import gradslam_tpu_torch.slam.stepgraph as stepgraph

    real_loss, real_call = parallel.slam_loss, stepgraph.GradStep.__call__
    if fault == "unchanged_step":
        def call(self, params, *a):
            out = real_call(self, params, *a)
            return params.scale.detach().clone(), params.bias.detach().clone(), out[2]

        monkeypatch.setattr(stepgraph.GradStep, "__call__", call)
    elif fault == "half_batch":
        def loss(params, rgb, depth, K, gt, *a, **k):
            h = rgb.shape[0] // 2
            return real_loss(params, rgb[:h], depth[:h], K[:h], gt[:h], *a, **k)

        monkeypatch.setattr(parallel, "slam_loss", loss)
    else:
        monkeypatch.setattr(parallel, "slam_loss", lambda *a, **k: real_loss(*a, **k) * 1.1)


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_loss"])
def test_a_broken_training_step_is_not_correct(fault, tiny, monkeypatch):
    _train_fault(fault, monkeypatch)
    assert _run("pf-scannet-train16", tiny)["correct"] is False


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct_and_the_control_is_not(cell, tiny):
    from slam_bench.compare import verdict

    assert _run(cell, tiny)["correct"] is True
    wl, cfg = tiny(cell)
    driver = harness.load_module("drivers", wl["driver"])
    st = driver.setup(harness.Run(wl, cfg, 12, CPU, False))
    if wl["driver"] != "train_step":
        driver.window(st, 0.0)
    numbers = driver.gaps(st, driver.reference(st, lowered=True), driver.reference(st))
    assert verdict(numbers, wl["limits"])[0] is False
