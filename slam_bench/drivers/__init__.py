"""One module a kind of traffic, found by the name a workload file gives."""
