"""Kineto's count of the device records a profiler trace dropped.

Kineto drops the device records whose timestamps fall outside a trace's
window, and says how many in its INFO log ("Record counts: Out-of-range =
N") on standard error. The level is read once, when the process's first
trace starts, so ``KINETO_LOG_LEVEL=1`` has to be set before that: importing
this module sets it where a CUDA device is present (``chip_smoke.py``'s
``main`` sets it too). Used by the card tests and ``chip_smoke.py`` to tell a
record the trace lost from a kernel the device did not run.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import tempfile

import torch

if torch.cuda.is_available():
    os.environ.setdefault("KINETO_LOG_LEVEL", "1")

# Kineto's log lines, which ``kineto_log`` takes off stderr: its records
# count of a trace and the lines around it
KINETO_LINE = re.compile(r"^(INFO|STAGE|USDT|WARNING):\S+ \S+ \d+:\d+ \w+\.cpp:\d+\]|^  (Log file|Trace start time|"
                         r"Trace duration|Warmup duration|Max GPU buffer size|Enabled activities):")
OUT_OF_RANGE = re.compile(r"Record counts: Out-of-range = (\d+)")


@contextlib.contextmanager
def kineto_log():
    """Takes the process's stderr (file descriptor 2, where Kineto writes)
    while open; then yields {"out_of_range": the device records that
    Kineto's traces in it dropped as outside their window, None where its
    INFO log did not say} and writes the rest of what it took back to
    stderr."""
    found = {"out_of_range": None}
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 2)
        try:
            yield found
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            f.seek(0)
            lines = f.read().decode(errors="replace").splitlines()
    counts = [int(m.group(1)) for line in lines for m in [OUT_OF_RANGE.search(line)] if m]
    found["out_of_range"] = sum(counts) if counts else None
    rest = [line for line in lines if not KINETO_LINE.match(line)]
    if rest:
        print("\n".join(rest), file=sys.stderr, flush=True)
