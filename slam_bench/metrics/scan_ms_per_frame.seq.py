"""Device milliseconds of the scan kernels (the cumsums of the mapping's
compactions and appends) per frame of a whole sequence."""

from slam_bench import trace


def read(record):
    if record["driver"] != "sequence":
        return None
    ms = trace.scan_ms(record["device_ops"])
    return ms / record["frames"] if ms > 0 else None
