"""One module a per-layer metric, found by the metric's name: ``read(record)``
takes the traced run's record (``trace.collect``'s lists and the driver's
counts) and returns the metric, or None where the record holds nothing
for it."""
