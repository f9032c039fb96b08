"""Host calls that start device work (kernel and graph launches) per frame
of an incremental session (``init_state`` / ``step_state``)."""

from slam_bench import trace


def read(record):
    if record["driver"] != "online_step":
        return None
    return trace.host_calls(record["host_ops"]) / record["frame_steps"]
