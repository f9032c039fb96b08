"""The plain reference of the benchmark (:mod:`.pointfusion`): PointFusion
with gradICP odometry, written out for one device from upstream gradslam's
algorithms. It imports nothing of the port and nothing of the benchmark, so
a change to either leaves it as it is. :mod:`.precision` lowers its
products to TF32 for the control."""

from . import precision
from .pointfusion import Options, sequence

__all__ = ["precision", "Options", "sequence"]
