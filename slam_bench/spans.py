"""Device time inside the port's span marks: the arithmetic of the
per-layer metrics that read them (``metrics/odometry_ms_per_frame.seq.py``,
``odometry_targets_ms_per_frame.seq.py``, ``mapping_ms_per_frame.seq.py``,
``forward_ms_per_step.train.py``, ``backward_ms_per_step.train.py`` and
``step_idle_ms_per_frame.online.py``).

The port marks each end of a layer's span on the device with an empty
kernel named after the span (``gs_span_begin_<span>``,
``gs_span_end_<span>``); a CUDA graph captured with them replays them in
capture order between the layer's kernels. Each metric names the marks it
reads in its own file, so this yardstick does not move with the program.
A span's device time is the union of the device operations that start
after its begin mark ends and end before its end mark starts, over every
instance in the traced unit; the marks themselves are left out.
:func:`span_us`, :func:`extent_us` and :func:`host_idle_us` return None
where the trace holds no such mark or span (a program without them).
"""

from __future__ import annotations

import bisect

from slam_bench import trace

MARK_PREFIX = "gs_span_"


def _is(name: str, marks) -> bool:
    return any(name == m or name.startswith(m + "(") for m in marks)


def windows(device_ops, begins, ends):
    """(start, stop) of every instance: each begin mark's end to the start
    of the first end mark after it."""
    ordered = sorted(device_ops, key=lambda r: (r[1], r[2]))
    out, start = [], None
    for name, s, e in ordered:
        if start is None and _is(name, begins):
            start = e
        elif start is not None and _is(name, ends):
            out.append((start, s))
            start = None
    return out


def inside_us(device_ops, intervals) -> float:
    """Microseconds covered by the device operations (marks left out) that
    lie wholly inside one of ``intervals`` (which do not overlap)."""
    intervals = sorted(intervals)
    starts = [a for a, _ in intervals]
    ops = []
    for r in device_ops:
        i = bisect.bisect_right(starts, r[1]) - 1
        if i >= 0 and r[2] <= intervals[i][1] and not r[0].startswith(MARK_PREFIX):
            ops.append(r)
    return trace.covered_us(ops)


def union(ops):
    """The union of ``ops``' intervals as sorted, disjoint [start, end]."""
    merged = []
    for s, e in sorted((s, e) for _, s, e in ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def span_us(device_ops, begins, ends):
    """Device microseconds inside every instance of a span whose begin
    marks are ``begins`` and end marks ``ends``; None without one."""
    found = windows(device_ops, begins, ends)
    return inside_us(device_ops, found) if found else None


def extent_us(device_ops, begins, ends):
    """Device microseconds from the end of the first of ``begins`` to the
    start of the last of ``ends``; None without both."""
    starts = [e for n, _, e in device_ops if _is(n, begins)]
    stops = [s for n, s, _ in device_ops if _is(n, ends)]
    if not starts or not stops:
        return None
    return inside_us(device_ops, [(min(starts), max(stops))])


def host_idle_us(device_ops, host_ops, names):
    """Microseconds inside the host spans named ``names`` (their union) in
    which no device operation ran; None without such a span."""
    spans = union([r for r in host_ops if r[0] in names])
    if not spans:
        return None
    busy = union(device_ops)
    starts = [s for s, _ in busy]
    idle = 0.0
    for a, b in spans:
        covered = 0.0
        for s, e in busy[max(0, bisect.bisect_right(starts, a) - 1):bisect.bisect_left(starts, b)]:
            covered += max(0.0, min(e, b) - max(s, a))
        idle += (b - a) - covered
    return idle
