"""The readings that the limits of a cell's compared numbers are set from,
on the card at the cell's own size; the benchmark's own runs never run it.

    python slam_bench/calibrate.py --workload <cell> --seeds <n> ... [--control 3] [--out FILE]

For each seed it sets the cell up as a run does, produces what the timed
path produces (a run's two first sequences or sessions, a training run's
first three steps), works out the plain reference and prints the program's
gaps to it: the lower readings. On the first ``--control`` seeds it also
prints the gaps of the control (the reference with its products in TF32,
put in the program's place) and, for a training cell, of the fault of a
step that leaves half of the batch out (the reference on the first half):
the upper readings. A state left unchanged reads 1 on the gradient and
change gaps by their measure and needs no run. The last line sums up, for
each number, the largest lower and the smallest upper reading.
"""

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import argparse
    import json
    import time

    import torch

    from slam_bench.harness import Run, load_json, load_module

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control and the faults")
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    driver = load_module("drivers", workload["driver"])
    dev = torch.device("cuda", 0)
    lower, upper = {}, {}

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        st = driver.setup(Run(workload, config, seed, dev, False))
        if workload["driver"] != "train_step":
            driver.window(st, 0.0)
        ref = driver.reference(st)
        readings = {"program": driver.gaps(st, driver.outputs(st), ref)}
        if i < args.control:
            readings["control"] = driver.gaps(st, driver.reference(st, lowered=True), ref)
            if workload["driver"] == "train_step":
                readings["half_batch"] = driver.gaps(st, driver.reference(st, batch=st.B // 2), ref)
        for kind, nums in readings.items():
            side = lower if kind == "program" else upper
            for k, v in nums.items():
                side.setdefault(k, []).append(v)
        emit({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **readings})
        driver.release(st)
        del st, ref
        torch.cuda.empty_cache()
    emit({"workload": args.workload, "seeds": len(args.seeds),
          "lower": {k: max(v) for k, v in lower.items()}, "upper": {k: min(v) for k, v in upper.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
