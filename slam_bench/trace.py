"""The arithmetic that turns a profiled run into per-layer numbers: a copy
of ``tools/profile_torch_port.py``'s interval union, host-call count and
kernel-name groups, kept here so that the benchmark's yardstick does not
move with the tools, and the latency percentile.

A profiled run is reduced to plain lists before anything reads it:
``device_ops`` (name, start us, end us) of every operation that ran on the
device (kernels, copies, fills) and ``host_ops`` the same of the host's
operations and CUDA runtime calls.
"""

from __future__ import annotations

import bisect
import math

# host calls of the CUDA runtime (cuda*) and its low-level API (cu*) that start device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
# the port's hand-written kernels, by the names of their CUDA functions (csrc/*.cu)
KNN_KERNELS = ("knn_cluster",)
WINNER_KERNELS = ("winner_grid",)
# the cumsums (ops/masking.compact_masked, the arena's appends): CUDA scan kernels
SCAN_MARK = "scan"


def collect(prof) -> dict:
    """``device_ops`` and ``host_ops`` of a finished ``torch.profiler.profile``,
    read from its raw events (building the profiler's own event objects
    takes minutes at a few hundred thousand kernels). The device's copy of
    a host span (``record_function``) is not an operation and is left out."""
    import torch

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not e.is_user_annotation():
            device.append(row)
    return {"device_ops": device, "host_ops": host}


def covered_us(ops) -> float:
    """Microseconds in which at least one of ``ops`` ran: the union of their
    intervals."""
    covered, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(ops, key=lambda r: (r[1], r[2])):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered


def idle_share(device_ops, wall_s: float) -> float:
    """1 - (union of the device's operations) / ``wall_s``, the wall time of
    the profiled run that ran them. Both come from one run, so the share
    lies in [0, 1]; the profiler's own host work counts as idle time."""
    return 1.0 - covered_us(device_ops) / 1e6 / wall_s


def host_calls(host_ops, names=LAUNCH_CALLS) -> int:
    """Host calls whose names start with one of ``names``."""
    return sum(1 for n, _, _ in host_ops if n.startswith(names))


def device_ms(device_ops, marks) -> float:
    """Milliseconds of the operations whose names contain one of ``marks``."""
    return sum(e - s for n, s, e in device_ops if any(m in n for m in marks)) / 1e3


def kernel_count(device_ops) -> int:
    """Kernels among the device's operations (copies and fills left out)."""
    return sum(1 for n, _, _ in device_ops if not n.startswith(("Memcpy", "Memset")))


def scan_ms(device_ops) -> float:
    return sum(e - s for n, s, e in device_ops if SCAN_MARK in n.lower()) / 1e3


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of ``values`` at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def breakdown(device_ops, host_ops, top: int = 10) -> dict:
    """The device operations that took the most time, summed by name, and
    the device's idle time summed by what the host was doing: each gap
    between device operations is named by the innermost host operation
    running at its middle (``idle`` where none ran), in seconds."""
    by_name = {}
    for n, s, e in device_ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    gaps, cur_e = [], None
    for _, s, e in sorted(device_ops, key=lambda r: (r[1], r[2])):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    host = sorted(host_ops, key=lambda r: r[1])
    starts = [r[1] for r in host]
    by_host = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "idle"
        # the innermost host operation at the gap's middle: the latest start of those still running
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - 2000), -1):
            if host[i][2] >= mid:
                label = host[i][0]
                break
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) / 1e6
    rank = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(by_host)}
