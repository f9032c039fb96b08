"""The benchmark of ``gradslam_tpu_torch`` on one NVIDIA H100 (see
``run.py``). Cells, configurations, drivers and per-layer metrics are files
found by name: ``workloads/<cell>.json``, ``configs/<config>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``."""
