"""Milliseconds per frame in which the device is idle while the host is
inside the port's ``step_state`` or ``init_state`` span (hand-over into
the static buffers, graph launch, copy-out): the part of the device's idle
time that the port's own host path causes."""

from slam_bench import spans

HOST_SPANS = ("step_state", "init_state")


def read(record):
    if record["driver"] != "online_step":
        return None
    us = spans.host_idle_us(record["device_ops"], record["host_ops"], HOST_SPANS)
    return None if us is None else us / 1e3 / record["frame_steps"]
