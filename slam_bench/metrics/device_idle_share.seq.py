"""The device's idle share of the traced work (sequence driver): 1 - the union of
its operations' intervals over the wall time of the same profiled run."""

from slam_bench import trace


def read(record):
    if record["driver"] != "sequence":
        return None
    return trace.idle_share(record["device_ops"], record["wall_profiled_s"])
