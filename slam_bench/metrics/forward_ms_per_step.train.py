"""Device milliseconds per training step of the forward through SLAM: from
the first forward mark of the port's ``init_state``, ``odometry`` and
``mapping`` spans to the last one (loss and update left out)."""

from slam_bench import spans

BEGIN = ("gs_span_begin_init_state", "gs_span_begin_odometry", "gs_span_begin_mapping")
END = ("gs_span_end_init_state", "gs_span_end_odometry", "gs_span_end_mapping")


def read(record):
    if record["driver"] != "train_step":
        return None
    us = spans.extent_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["steps"]
