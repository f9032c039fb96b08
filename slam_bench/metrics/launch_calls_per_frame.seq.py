"""Host calls that start device work (kernel and graph launches) per frame
step of a whole sequence: the frame loop and its captured graphs."""

from slam_bench import trace


def read(record):
    if record["driver"] != "sequence":
        return None
    return trace.host_calls(record["host_ops"]) / record["frame_steps"]
