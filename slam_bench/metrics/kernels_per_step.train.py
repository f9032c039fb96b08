"""Device kernels (copies and fills left out) in one training step."""

from slam_bench import trace


def read(record):
    if record["driver"] != "train_step":
        return None
    return trace.kernel_count(record["device_ops"]) / record["steps"]
