"""A short run of a cell on the card, at its own size: it comes out correct
and reports its metrics. Skips where torch sees no CUDA card."""

import json
import time

import pytest
import torch

from conftest import ROOT

from slam_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_online_cell_runs_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = harness.load_json("workloads", "pf-scannet-online")
    cfg = harness.load_json("configs", wl["config"])
    readers = {m["name"]: harness.load_module("metrics", m["name"])
               for m in harness.cell_metrics(bench, "per_layer", wl["name"])}
    run = harness.Run(wl, cfg, 2**33 + 3, torch.device("cuda", 0), bool(trace))
    result, _ = harness.execute(bench, run, harness.load_module("drivers", wl["driver"]), readers, 1.0,
                                time.perf_counter())
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in harness.cell_metrics(
        bench, "per_layer" if trace else "end_to_end", wl["name"])}
