"""Device milliseconds per sequence inside the port's ``loop_closure`` span:
the whole closure (frame clouds, descriptors, both detectors, verification,
dedup and the pose graph), one captured graph of the loop cell."""

from slam_bench import spans

BEGIN, END = ("gs_span_begin_loop_closure",), ("gs_span_end_loop_closure",)


def read(record):
    if record["driver"] != "loop_sequence":
        return None
    us = spans.span_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["sequences"]
