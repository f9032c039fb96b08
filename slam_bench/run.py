"""Runs one cell of the benchmark of the PyTorch/CUDA port once.

    python slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as its last line, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``, then the compared numbers with
their limits under ``checks``. Exits non-zero, printing no result, without
the CUDA cards the cell asks for.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every cache the run writes lives at a fixed path inside the checkout, so a
# cell's later runs find what its first run built
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from slam_bench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
