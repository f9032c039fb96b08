"""Helpers of the benchmark's own CPU tests (``python -m pytest slam_bench/tests``;
the repository's ``pytest tests/`` does not collect them)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell cut to a size a CPU test holds: 24x32 frames, a few of them
TINY_TRAFFIC = {
    "pf-scannet-seq64": dict(batch=2, frames=3, distinct=2, warm_runs=1),
    "pf-scannet-train16": dict(batch=2, frames=3, distinct=3),
    "pf-scannet-online": dict(batch=1, frames=3, distinct=2, warm_frames=2),
}


def tiny_cell(name: str):
    """(workload, config) of a cell from its files, cut to a CPU test's size."""
    from slam_bench.harness import load_json

    wl = load_json("workloads", name)
    cfg = load_json("configs", wl["config"])
    cfg = dict(cfg, height=24, width=32, intrinsics=dict(fx=13.125, fy=13.125, cx=15.5, cy=11.5))
    return dict(wl, traffic=dict(wl["traffic"], **TINY_TRAFFIC[name])), cfg


@pytest.fixture
def tiny():
    return tiny_cell
