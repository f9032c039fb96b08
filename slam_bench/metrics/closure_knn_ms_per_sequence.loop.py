"""Device milliseconds per sequence of the KNN kernel (``knn_cluster``)
inside the port's ``loop_closure.verify`` span: the verification's
association and inlier search at the closure's shapes."""

from slam_bench import spans, trace

BEGIN, END = ("gs_span_begin_loop_closure__verify",), ("gs_span_end_loop_closure__verify",)


def read(record):
    if record["driver"] != "loop_sequence":
        return None
    found = spans.windows(record["device_ops"], BEGIN, END)
    if not found:
        return None
    knn = [r for r in record["device_ops"] if any(k in r[0] for k in trace.KNN_KERNELS)]
    return spans.inside_us(knn, found) / 1e3 / record["sequences"]
