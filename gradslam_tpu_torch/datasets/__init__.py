from . import datautils, imagefile, tumutils
from .dataloader import DataLoader, default_collate
from .icl import ICL
from .scannet import Scannet, get_color_encoding, nyu40_to_scannet20
from .tum import TUM

__all__ = [
    "TUM",
    "ICL",
    "Scannet",
    "DataLoader",
    "default_collate",
    "datautils",
    "tumutils",
    "imagefile",
    "nyu40_to_scannet20",
    "get_color_encoding",
]
