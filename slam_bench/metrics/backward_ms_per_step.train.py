"""Device milliseconds per training step of the backward through SLAM: from
the first ``.backward`` mark of the port's ``init_state``, ``odometry`` and
``mapping`` spans to the last one."""

from slam_bench import spans

BEGIN = ("gs_span_begin_init_state__backward", "gs_span_begin_odometry__backward",
         "gs_span_begin_mapping__backward")
END = ("gs_span_end_init_state__backward", "gs_span_end_odometry__backward", "gs_span_end_mapping__backward")


def read(record):
    if record["driver"] != "train_step":
        return None
    us = spans.extent_us(record["device_ops"], BEGIN, END)
    return None if us is None else us / 1e3 / record["steps"]
