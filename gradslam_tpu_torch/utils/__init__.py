from .checkpoint import load_slam_state, save_slam_state
from .device import resolve_device
from .profiling import DeviceTimer, annotate, sync, trace

__all__ = [
    "resolve_device",
    "save_slam_state",
    "load_slam_state",
    "DeviceTimer",
    "annotate",
    "sync",
    "trace",
]
