"""One run of one cell: load it by name, make its inputs on the card from
the seed, warm up, measure (or trace), check the timed path's outputs
against the plain reference, and print the result.

A cell is ``workloads/<cell>.json``: its configuration (``configs/<name>.json``),
its driver (``drivers/<name>.py``), its traffic and the limit of every
number compared. A driver module has ``setup(run)`` (inputs, the port's
system, warm-up), ``window(state, seconds)``, ``traced(state)``,
``release(state)`` (frees the port before the reference runs) and
``check(state)``, which is ``gaps(state, outputs(state), reference(state))``:
the compared numbers of what the timed path produced against the plain
reference (``reference(state, lowered=True)`` is the control). A
per-layer metric is ``metrics/<metric>.py`` with ``read(record)``, which
returns None where the traced run holds nothing for it. Which metrics a
cell reports is ``BENCHMARK.json``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass

from slam_bench import common

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "gradslam_tpu")


@dataclass
class Run:
    """What a driver is given: the cell, its configuration, the seed and the card."""

    workload: dict
    config: dict
    seed: int
    device: object
    trace: bool


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location(f"slam_bench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


WORKLOAD_KEYS = {"name", "config", "driver", "chips", "traffic", "why", "limits"}


def validate(bench: dict, workload: dict, config: dict) -> None:
    """Refuses a cell whose files do not fit together, before any work."""
    name = workload.get("name")
    missing = WORKLOAD_KEYS - set(workload)
    if missing:
        raise SystemExit(f"workload {name!r} lacks {sorted(missing)}")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"workload {name!r} is not in BENCHMARK.json")
    if (entry["config"], entry["traffic"], entry["chips"]) != (
            workload["config"], workload["traffic"].get("name"), workload["chips"]):
        raise SystemExit(f"workload {name!r}: its file and BENCHMARK.json disagree on config, traffic or chips")
    if config.get("name") != workload["config"]:
        raise SystemExit(f"configuration file {workload['config']!r} names {config.get('name')!r}")
    if not workload["limits"]:
        raise SystemExit(f"workload {name!r} gives no limit for its compared numbers")


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``BENCHMARK.json``'s ``section`` that ``cell`` reports."""
    return [m for m in bench.get(section, []) if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``gradslam_tpu_torch`` is not ``gradslam_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


class ClockLog:
    """``nvidia-smi`` sampling the card's SM clock, power and throttle
    reasons every half second while the measured work runs, in a process
    of its own that is stopped and waited for at the end: the spread of a
    host-clock metric is read beside it."""

    QUERY = "clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                                          "-lms", "500"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = [r.split(", ") for r in out.splitlines() if r.count(",") == 3]
        try:
            sm = [float(r[0]) for r in rows]
            watts = [float(r[1]) for r in rows]
            reasons = sorted({r[3] for r in rows})
            print(f"card while measuring: SM clock {min(sm)}-{max(sm)} MHz, power {min(watts)}-{max(watts)} W, "
                  f"temperature {rows[0][2]}-{rows[-1][2]} C, throttle reasons {reasons} ({len(rows)} samples)",
                  flush=True)
        except (ValueError, IndexError):
            print(f"card while measuring: not read ({out[:200]!r})", flush=True)
        return False


def capture_seconds() -> list:
    """Seconds each of the port's captured graphs took to capture."""
    from gradslam_tpu_torch.slam import stepgraph

    return [round(g.capture_s, 6) for cache in list(stepgraph._CACHES) for g in cache.graphs.values()
            if getattr(g, "capture_s", None) is not None]


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    validate(bench, workload, config)
    driver = load_module("drivers", workload["driver"])
    readers = {m["name"]: load_module("metrics", m["name"]) for m in cell_metrics(bench, "per_layer", args.workload)}

    import torch

    import gradslam_tpu_torch  # noqa: F401  (the system under test; a checkout without it fails here)

    chips = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {time.perf_counter() - t_start:.3f} s from process start", flush=True)

    run = Run(workload, config, args.seed, dev, bool(args.trace))
    result, rows = execute(bench, run, driver, readers, args.seconds, t_start)
    if result is None:
        return 3
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


def execute(bench: dict, run: Run, driver, readers: dict, seconds: float, t_start: float):
    """Everything of a run after the look for a card: set-up, the window
    (or the traced work), the reference and the verdict. Returns (the result
    line's object, [(name, value, limit)]), or (None, None) when modules of
    JAX or the JAX package were loaded."""
    import torch

    from slam_bench import trace
    from slam_bench.compare import verdict

    cell, on_card = run.workload["name"], run.device.type == "cuda"
    state = driver.setup(run)
    common.sync(run.device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.6f} s; graphs captured in {capture_seconds()} s", flush=True)

    device = {"platform": "gpu" if on_card else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if on_card else run.device.type,
              "count": int(run.workload.get("chips", 1))}
    breakdown = None
    clocks = ClockLog() if on_card else contextlib.nullcontext()
    if run.trace:
        with clocks:
            record, attempted = driver.traced(state)
        metrics = {}
        for m in cell_metrics(bench, "per_layer", cell):
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = trace.covered_us(record["device_ops"]) / 1e6
        device["window_s"] = record["wall_profiled_s"]
        breakdown = trace.breakdown(record["device_ops"], record["host_ops"])
    else:
        with clocks:
            measured, attempted = driver.window(state, seconds)
        measured["setup_s"] = setup_s
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, "end_to_end", cell)}
    common.sync(run.device)
    device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    print(f"peak device memory {device['memory_peak_bytes']} bytes; card and power limit "
          f"{power_limit() if on_card else 'none'}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return None, None

    driver.release(state)
    t0 = time.perf_counter()
    numbers = driver.check(state)
    correct, rows = verdict(numbers, run.workload["limits"])
    print(f"reference and comparison {time.perf_counter() - t0:.3f} s", flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return None, None
    # a number that is not finite is printed as a string, so that the line stays JSON
    plain = lambda x: x if x is None or math.isfinite(x) else str(x)
    result = {"correct": correct, "attempted": attempted, "failed": 0 if correct else 1, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": plain(value), "limit": limit} for name, value, limit in rows}
    return result, rows
