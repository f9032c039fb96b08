"""Device milliseconds per frame inside the port's ``odometry`` span
(localization: the targets' selection and ICP) over a whole sequence."""

from slam_bench import spans

BEGIN, END = ("gs_span_begin_odometry",), ("gs_span_end_odometry",)


def read(record):
    if record["driver"] != "sequence":
        return None
    us = spans.span_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["frames"]
