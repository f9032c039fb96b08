"""Device milliseconds per frame inside the port's ``mapping`` span (the
fusion of each frame into the arena, frame 0's included) over a whole
sequence."""

from slam_bench import spans

BEGIN, END = ("gs_span_begin_mapping",), ("gs_span_end_mapping",)


def read(record):
    if record["driver"] != "sequence":
        return None
    us = spans.span_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["frames"]
