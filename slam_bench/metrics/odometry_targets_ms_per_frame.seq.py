"""Device milliseconds per frame inside the port's ``odometry.targets``
span (the projection of the candidate rows, the compaction of those on the
pixel grid and the gather of their rows) over a whole sequence."""

from slam_bench import spans

BEGIN, END = ("gs_span_begin_odometry__targets",), ("gs_span_end_odometry__targets",)


def read(record):
    if record["driver"] != "sequence":
        return None
    us = spans.span_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["frames"]
