"""Device milliseconds of the KNN kernel (``knn_cluster``) per frame of a
whole sequence: odometry's association, and loop closure's where it runs."""

from slam_bench import trace


def read(record):
    if record["driver"] != "sequence":
        return None
    ms = trace.device_ms(record["device_ops"], trace.KNN_KERNELS)
    return ms / record["frames"] if ms > 0 else None
