"""The loop cell (``icpslam-loop-tum480``) cut to a CPU test's size: a sound
run is correct; a run whose closure is broken underneath is not, nor is the
control. The cut keeps the whole 100-frame loop and the cell's detection
gates, at 24x32 with every second pixel (the clouds' spacing of the cell's
every fourth pixel at 480x640 times ten, so the inlier distance is tripled)
and 10 iterations of each ICP. Each run drives the harness after its look
for a card (``harness.execute``), with the cell's own limits.

The faults: a closure that returns the poses it was given, a verification
that accepts nothing, a pose graph of no iteration, and every refined pose
moved by a centimetre."""

import json
import time

import pytest
import torch

from conftest import ROOT

from slam_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
CELL = "icpslam-loop-tum480"
TINY_CLOSURE = dict(dsratio=2, icp_numiters=10, inlier_dist=0.15)


def tiny_loop():
    """(workload, config) of the loop cell cut to 24x32 (one loop of 100
    frames, one distinct loop and one warm run)."""
    wl = harness.load_json("workloads", CELL)
    cfg = harness.load_json("configs", wl["config"])
    opts = dict(cfg["options"], dsratio=2, numiters=10)
    opts["loop_closure_kwargs"] = dict(opts["loop_closure_kwargs"], **TINY_CLOSURE)
    cfg = dict(cfg, height=24, width=32, intrinsics=dict(fx=26.25, fy=26.25, cx=15.5, cy=11.5), options=opts)
    return dict(wl, traffic=dict(wl["traffic"], distinct=1, warm_runs=1)), cfg


def _run(seed=5):
    wl, cfg = tiny_loop()
    run = harness.Run(wl, cfg, seed, CPU, False)
    result, _ = harness.execute(BENCH, run, harness.load_module("drivers", wl["driver"]), {}, 0.0,
                                time.perf_counter())
    return result


def _input_poses(monkeypatch):
    import gradslam_tpu_torch.slam.loopclosure as lc

    monkeypatch.setattr(lc, "close_loops_rgbd", lambda rgb, depth, K, poses, **kw: poses)


def _accepts_nothing(monkeypatch):
    import gradslam_tpu_torch.slam.loopclosure as lc

    real = lc.verify_loop_closures

    def verify(*a, **k):
        Z, w = real(*a, **k)
        return Z, torch.zeros_like(w)

    monkeypatch.setattr(lc, "verify_loop_closures", verify)


def _no_iteration(monkeypatch):
    import gradslam_tpu_torch.slam.loopclosure as lc

    real = lc.pose_graph_refine
    monkeypatch.setattr(lc, "pose_graph_refine", lambda graph, num_iters=10, **k: real(graph, num_iters=0, **k))


def _moved(monkeypatch):
    import gradslam_tpu_torch.slam.loopclosure as lc

    real = lc.close_loops_rgbd

    def closed(*a, **k):
        poses = real(*a, **k).clone()
        poses[..., 0, 3] += 1e-2
        return poses

    monkeypatch.setattr(lc, "close_loops_rgbd", closed)


FAULTS = {"input_poses": _input_poses, "accepts_nothing": _accepts_nothing, "no_iteration": _no_iteration,
          "moved_1cm": _moved}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_closure_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert _run()["correct"] is False


def test_a_sound_run_is_correct_and_the_control_is_not():
    from slam_bench.compare import verdict

    result = _run()
    assert result["correct"] is True, result["checks"]
    wl, cfg = tiny_loop()
    driver = harness.load_module("drivers", wl["driver"])
    st = driver.setup(harness.Run(wl, cfg, 5, CPU, False))
    driver.window(st, 0.0)
    ref = driver.reference(st)
    assert ref[2][0], "the reference accepts a loop pair at this size"
    numbers = driver.gaps(st, driver.reference(st, lowered=True), ref)
    assert verdict(numbers, wl["limits"])[0] is False
