"""Device milliseconds per sequence inside the port's ``loop_closure.verify``
span: each detector's batched gradICP verification and its inlier KNN."""

from slam_bench import spans

BEGIN, END = ("gs_span_begin_loop_closure__verify",), ("gs_span_end_loop_closure__verify",)


def read(record):
    if record["driver"] != "loop_sequence":
        return None
    us = spans.span_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["sequences"]
