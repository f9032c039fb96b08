"""The port's spans on the card: what each layer's span holds of a
benchmark cell's traced unit, and what the device marks cost.

    python tools/span_report.py report --workload <cell> --seed <n> [--equal] [--out FILE]
    python tools/span_report.py run --marks <0|1> --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``report`` sets the cell up as ``slam_bench/run.py`` does (its driver, its
inputs from the seed, warm-up and capture, with the marks), profiles one
traced unit and prints one JSON object: each span's device milliseconds a
unit and that of its scan kernels (``gs_span_*`` marks, forward and
``.backward``), the share of the unit's device busy time that the
top-level spans cover (``init_state``, ``odometry``, ``mapping``,
``carry``, ``loop_closure``; a training step's forward and backward), the
marks the device ran (their count, their device time, the order of one
frame step's), the
host time inside each host span, the idle gaps by what the host was doing,
and the cell's per-layer metrics as the benchmark reads them. With ``--equal`` it
then drops the graphs, captures them again inside
``profiling.device_spans(False)`` and compares the outputs of the same unit
with and without marks (sequences and sessions bit for bit; a training
step's loss bit for bit and its parameters to the backward's float
atomics).

``run`` is ``slam_bench/run.py`` inside ``profiling.device_spans(marks)``:
with ``--marks 0`` every graph is captured without marks, so the pair of
runs on one seed measures what the marks cost when no profiler runs.
"""

import time

T_START = time.perf_counter()

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def _windows(device_ops, span):
    from gradslam_tpu_torch.utils.profiling import mark_name
    from slam_bench import spans

    return spans.windows(device_ops, (mark_name(span, "begin"),), (mark_name(span, "end"),))


def _covered_inside(device_ops, windows):
    """Device microseconds (marks left out) inside the union of ``windows``."""
    from slam_bench import spans

    return spans.inside_us(device_ops, [(a, b) for a, b in spans.union([("", a, b) for a, b in windows])])


def analyse(record: dict) -> dict:
    from gradslam_tpu_torch.utils import profiling
    from slam_bench import spans, trace

    ops, unit = record["device_ops"], record["steps"] if record["driver"] == "train_step" else record["frames"]
    plain = [r for r in ops if not r[0].startswith(spans.MARK_PREFIX)]
    marks = [r for r in sorted(ops, key=lambda r: r[1]) if r[0].startswith(spans.MARK_PREFIX)]
    busy = trace.covered_us(plain)
    scans = [r for r in plain if trace.SCAN_MARK in r[0].lower()]
    per = {}
    for s in profiling.DEVICE_SPANS:
        for name in (s, s + ".backward"):
            w = _windows(ops, name)
            if w:
                per[name] = {"instances": len(w), "ms_per_unit": _covered_inside(ops, w) / 1e3 / unit,
                             "scan_ms_per_unit": _covered_inside(scans, w) / 1e3 / unit}
    if record["driver"] == "train_step":
        parts = {k: spans.extent_us(ops, *(tuple(profiling.mark_name(s + sfx, e) for s in
                                                 ("init_state", "odometry", "mapping")) for e in ("begin", "end")))
                 for k, sfx in (("forward", ""), ("backward", ".backward"))}
        top = sum(v or 0.0 for v in parts.values())
    else:
        parts = None
        top = _covered_inside(ops, [w for s in ("init_state", "odometry", "mapping", "carry", "loop_closure")
                                    for w in _windows(ops, s)])
    host = {}
    for n, s, e in record["host_ops"]:
        if n in profiling.SPANS:
            host.setdefault(n, [0, 0.0])
            host[n][0] += 1
            host[n][1] += (e - s) / 1e3
    names = [m[0] for m in marks]
    step = [profiling.mark_name(n, e) for n, e in (("odometry", "begin"), ("odometry.targets", "begin"),
                                                   ("odometry.targets", "end"), ("odometry", "end"),
                                                   ("mapping", "begin"), ("mapping", "end"),
                                                   ("carry", "begin"), ("carry", "end"))]
    first = names.index(step[0]) if step[0] in names else None
    return {
        "driver": record["driver"], "unit": "step" if record["driver"] == "train_step" else "frame",
        "units": unit, "busy_ms": busy / 1e3, "wall_profiled_s": record["wall_profiled_s"],
        "span_ms_per_unit": per,
        "top_level_share_of_busy": top / busy if busy else None,
        "train_parts_ms": None if parts is None else {k: (v or 0.0) / 1e3 for k, v in parts.items()},
        "marks": {"count": len(marks), "device_ms": sum(e - s for _, s, e in marks) / 1e3,
                  "first": names[:12], "frame_step": names[first:first + len(step)] if first is not None else None,
                  "frame_step_expected": step},
        "host_span_ms": {k: {"calls": v[0], "ms": v[1]} for k, v in sorted(host.items())},
        "scan_ms_per_unit": trace.covered_us(scans) / 1e3 / unit,
        "idle_gaps": trace.breakdown(ops, record["host_ops"])["idle_gaps"],
    }


def _equal(driver_name, driver, st) -> dict:
    """The traced unit's outputs with the marks captured, then with graphs
    captured again without them."""
    import torch

    from gradslam_tpu_torch import clear_graphs
    from gradslam_tpu_torch.utils import profiling

    def again(fn, warm):
        clear_graphs()
        with profiling.device_spans(False):
            for _ in range(warm):
                fn()
            return fn()

    if driver_name in ("sequence", "loop_sequence"):
        from slam_bench.drivers.sequence import _one

        run = lambda: _one(st, 0)
        a = run()
        b = again(run, 2)
        return {"poses": torch.equal(a[1], b[1]), "points": torch.equal(a[0].points_padded, b[0].points_padded),
                "normals": torch.equal(a[0].normals_padded, b[0].normals_padded),
                "colors": torch.equal(a[0].colors_padded, b[0].colors_padded)}
    if driver_name == "online_step":
        run = lambda: driver._session(st, 0)
        a = run()
        b = again(run, 1)
        return {"poses": torch.equal(a[1], b[1]), "map": torch.equal(a[0].map_state.data, b[0].map_state.data),
                "num_points": torch.equal(a[0].map_state.num_points, b[0].map_state.num_points)}
    c = st.clips[0]
    run = lambda: [x.detach().clone() for x in st.train(st.params, *c, st.opts, st.capacity)]
    a = run()
    b = again(run, 2)
    return {"loss": torch.equal(a[2], b[2]),
            "params_rel_gap": max(float((x - y).abs() / y.abs().clamp_min(1e-30)) for x, y in zip(a[:2], b[:2]))}


def report(args) -> int:
    import torch

    from slam_bench import common, harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    harness.validate(bench, workload, config)
    driver = harness.load_module("drivers", workload["driver"])
    readers = {m["name"]: harness.load_module("metrics", m["name"])
               for m in harness.cell_metrics(bench, "per_layer", args.workload)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = harness.Run(workload, config, args.seed, torch.device(args.device), True)
    st = driver.setup(run)
    common.sync(run.device)
    record, _ = driver.traced(st)
    card = harness.power_limit() if run.device.type == "cuda" else "none"
    out = {"workload": args.workload, "seed": args.seed, "card": card, **analyse(record),
           "metrics": {k: r.read(record) for k, r in readers.items()}}
    if args.equal:
        out["equal_without_marks"] = _equal(workload["driver"], driver, st)
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    rp = sub.add_parser("report")
    rp.add_argument("--workload", required=True)
    rp.add_argument("--seed", type=int, required=True)
    rp.add_argument("--equal", action="store_true")
    rp.add_argument("--out")
    rp.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)  # cpu: a rehearsal
    rr = sub.add_parser("run")
    rr.add_argument("--marks", type=int, choices=(0, 1), required=True)
    args, rest = ap.parse_known_args(argv)
    if args.mode == "report":
        return report(args)
    from gradslam_tpu_torch.utils import profiling
    from slam_bench import harness

    with profiling.device_spans(bool(args.marks)):
        return harness.main(rest, T_START)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
