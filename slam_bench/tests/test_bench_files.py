"""``BENCHMARK.json`` and the files it names: every file loads, every name
and unit keeps to the allowed characters, and each cell finds its
configuration, driver and metric readers by name."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "slam_bench/run.py"]
    assert BENCH["paths"] == ["slam_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries_keep_to_the_contract():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k], (e["name"], k)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if "workloads" in m:
            assert set(m["workloads"]) <= set(CELLS), m["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_by_name_and_reports_what_it_must(cell):
    from slam_bench.harness import cell_metrics, load_json, load_module

    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = load_json("workloads", cell)
    cfg = load_json("configs", wl["config"])
    assert wl["name"] == cell and wl["config"] == entry["config"] and wl["traffic"]["name"] == entry["traffic"]
    assert wl["chips"] == entry["chips"] == 1 and wl["why"] == entry["why"]
    assert cfg["name"] == entry["config"]
    driver = load_module("drivers", wl["driver"])
    for fn in ("setup", "window", "traced", "release", "check", "outputs", "reference", "gaps"):
        assert callable(getattr(driver, fn)), fn
    e2e = [m["name"] for m in cell_metrics(BENCH, "end_to_end", cell)]
    layer = cell_metrics(BENCH, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(load_module("metrics", m["name"]).read)
    assert wl["limits"], "every compared number has its limit"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_file_is_its_own(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and path.parent == ROOT / "slam_bench" / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"].startswith(entry["source"].split(" ")[0])
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for k in entry["reduced"]:
        assert NAME.match(k) and k in cfg
    assert sum(e["file"] == entry["file"] for e in BENCH["configs"]) == 1
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"frame loop and captured graphs", "odometry and its kernel", "mapping", "training step",
                      "device"}
