"""ScanNet dataset loader (host-side numpy; the JAX
package's loader, decoding through :mod:`.imagefile`).

Parity surface with the reference loader (gradslam/datasets/scannet.py:19):
driven by pre-extracted sequence-metadata files
(``sceneXXXX_XX-seq_Y.txt``, one line per frame pointing at
color/depth/pose/label/intrinsics files), per-scene intrinsics loaded from
file, depth scale 1000, semantic labels with the nyu40 -> scannet20 remap
and color palettes, and a start/end frame range instead of stride/dilation.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Union

import numpy as np

from . import datautils, imagefile

try:
    from natsort import natsorted
except ImportError:  # pragma: no cover - natsort is tiny, fallback ok
    natsorted = sorted

__all__ = ["Scannet", "nyu40_to_scannet20", "get_color_encoding"]

# scannet20: the 20-class benchmark subset of nyu40; other ids -> 0
_NYU40_TO_SCANNET20 = {
    0: 0, 13: 0, 15: 0, 17: 0, 18: 0, 19: 0, 20: 0, 21: 0, 22: 0, 23: 0,
    25: 0, 26: 0, 27: 0, 29: 0, 30: 0, 31: 0, 32: 0, 35: 0, 37: 0, 38: 0,
    40: 0, 14: 13, 16: 14, 24: 15, 28: 16, 33: 17, 34: 18, 36: 19, 39: 20,
}


def nyu40_to_scannet20(label: np.ndarray) -> np.ndarray:
    """Remaps nyu40 label ids to the scannet20 benchmark classes
    (reference scannet.py:483): ids 1-12 map to themselves, the 8 extra
    benchmark classes are renumbered 13-20, everything else becomes 0."""
    out = np.asarray(label).copy()
    for src, dst in _NYU40_TO_SCANNET20.items():
        out[label == src] = dst
    return out


def get_color_encoding(seg_classes: str = "scannet20"):
    """Ordered {class_name: (r, g, b)} palette (reference scannet.py:397)."""
    nyu40 = [
        ("unlabeled", (0, 0, 0)), ("wall", (174, 199, 232)),
        ("floor", (152, 223, 138)), ("cabinet", (31, 119, 180)),
        ("bed", (255, 187, 120)), ("chair", (188, 189, 34)),
        ("sofa", (140, 86, 75)), ("table", (255, 152, 150)),
        ("door", (214, 39, 40)), ("window", (197, 176, 213)),
        ("bookshelf", (148, 103, 189)), ("picture", (196, 156, 148)),
        ("counter", (23, 190, 207)), ("blinds", (178, 76, 76)),
        ("desk", (247, 182, 210)), ("shelves", (66, 188, 102)),
        ("curtain", (219, 219, 141)), ("dresser", (140, 57, 197)),
        ("pillow", (202, 185, 52)), ("mirror", (51, 176, 203)),
        ("floormat", (200, 54, 131)), ("clothes", (92, 193, 61)),
        ("ceiling", (78, 71, 183)), ("books", (172, 114, 82)),
        ("refrigerator", (255, 127, 14)), ("television", (91, 163, 138)),
        ("paper", (153, 98, 156)), ("towel", (140, 153, 101)),
        ("showercurtain", (158, 218, 229)), ("box", (100, 125, 154)),
        ("whiteboard", (178, 127, 135)), ("person", (120, 185, 128)),
        ("nightstand", (146, 111, 194)), ("toilet", (44, 160, 44)),
        ("sink", (112, 128, 144)), ("lamp", (96, 207, 209)),
        ("bathtub", (227, 119, 194)), ("bag", (213, 92, 176)),
        ("otherstructure", (94, 106, 211)), ("otherfurniture", (82, 84, 163)),
        ("otherprop", (100, 85, 144)),
    ]
    if seg_classes.lower() == "nyu40":
        return dict(nyu40)
    if seg_classes.lower() == "scannet20":
        keep = [
            "unlabeled", "wall", "floor", "cabinet", "bed", "chair", "sofa",
            "table", "door", "window", "bookshelf", "picture", "counter",
            "desk", "curtain", "refrigerator", "showercurtain", "toilet",
            "sink", "bathtub", "otherfurniture",
        ]
        d = dict(nyu40)
        return {k: d[k] for k in keep}
    raise ValueError(f"unknown seg_classes {seg_classes!r}")


class Scannet:
    """Dataset of ScanNet RGB-D(+semantics) frame sequences.

    Args:
        basedir: directory with ``sceneXXXX_XX/`` extractions.
        seqmetadir: directory of ``sceneXXXX_XX-seq_Y.txt`` metadata files.
        scenes: None (all), a tuple of scene names, or a path to a split
            ``.txt`` listing scene names.
        start / end: frame range within each metadata sequence (end=-1 for
            full sequence).
        height / width: output spatial size. Default 480x640.
        seg_classes: 'nyu40' or 'scannet20' label palette.
        channels_first / normalize_color / return_*: as :class:`TUM`.

    ``__getitem__`` returns (colors, depths, intrinsics, poses, transforms,
    names, labels) gated by the return flags.
    """

    _DEPTH_SCALE = 1000.0
    _RAW_H, _RAW_W = 480, 640

    def __init__(
        self,
        basedir: str,
        seqmetadir: str,
        scenes: Union[tuple, str, None],
        start: Optional[int] = 0,
        end: Optional[int] = -1,
        height: int = 480,
        width: int = 640,
        seg_classes: str = "scannet20",
        channels_first: bool = False,
        normalize_color: bool = False,
        *,
        return_depth: bool = True,
        return_intrinsics: bool = True,
        return_pose: bool = True,
        return_transform: bool = True,
        return_names: bool = True,
        return_labels: bool = True,
    ):
        if start < 0:
            raise ValueError(f"start must be non-negative, got {start}")
        if end != -1 and end <= start:
            raise ValueError(f"end ({end}) must be -1 or greater than start")
        self.height = height
        self.width = width
        self.seg_classes = seg_classes
        self.channels_first = channels_first
        self.normalize_color = normalize_color
        self.return_depth = return_depth
        self.return_intrinsics = return_intrinsics
        self.return_pose = return_pose
        self.return_transform = return_transform
        self.return_names = return_names
        self.return_labels = return_labels

        if isinstance(scenes, str):
            with open(scenes) as f:
                scenes = tuple(l.strip() for l in f if l.strip())

        self.sequences = []  # (name, color[], depth[], pose[], label[], Kfile)
        metas = natsorted(glob.glob(os.path.join(seqmetadir, "*.txt")))
        for metapath in metas:
            scene_name = os.path.basename(metapath).split("-")[0]
            if scenes is not None and scene_name not in scenes:
                continue
            with open(metapath) as f:
                lines = [l.strip() for l in f if l.strip()]
            e = len(lines) if end == -1 else min(end, len(lines))
            lines = lines[start:e]
            cfiles, dfiles, pfiles, lfiles, kfile = [], [], [], [], None
            for line in lines:
                p = line.split()
                # line format: color <f> depth <f> pose <f> label-filt <f>
                #   ... intrinsic_depth <f> ...
                kv = {p[i]: p[i + 1] for i in range(0, len(p) - 1, 2)}
                cfiles.append(os.path.join(basedir, kv["color"]))
                dfiles.append(os.path.join(basedir, kv["depth"]))
                pfiles.append(os.path.join(basedir, kv["pose"]))
                if "label-filt" in kv:
                    lfiles.append(os.path.join(basedir, kv["label-filt"]))
                if kfile is None and "intrinsic_depth" in kv:
                    kfile = os.path.join(basedir, kv["intrinsic_depth"])
            name = os.path.basename(metapath).split(".")[0]
            self.sequences.append((name, cfiles, dfiles, pfiles, lfiles, kfile))

        if not self.sequences:
            raise ValueError("no sequences found for the given scenes")

    def __len__(self):
        return len(self.sequences)

    @property
    def decode_route(self) -> str:
        """How frames are decoded: the Python path's route
        (:func:`.imagefile.python_route`); JPEG color needs 'imageio' or
        'pillow'."""
        return imagefile.python_route()

    def _load_color(self, path):
        img = imagefile.imread(path)
        if (img.shape[0], img.shape[1]) != (self.height, self.width):
            img = imagefile.resize(img, self.height, self.width, "linear")
        img = img.astype(np.float32)
        if self.normalize_color:
            img = datautils.normalize_image(img)
        return img

    def _load_depth(self, path):
        img = imagefile.imread(path).astype(np.float32)
        if (img.shape[0], img.shape[1]) != (self.height, self.width):
            img = imagefile.resize(img, self.height, self.width, "nearest")
        return (img / self._DEPTH_SCALE)[..., None]

    def _load_label(self, path):
        img = imagefile.imread(path).astype(np.int64)
        if (img.shape[0], img.shape[1]) != (self.height, self.width):
            img = imagefile.resize(img.astype(np.uint16), self.height, self.width, "nearest").astype(np.int64)
        if self.seg_classes.lower() == "scannet20":
            img = nyu40_to_scannet20(img)
        return img[..., None]

    def __getitem__(self, idx):
        name, cfiles, dfiles, pfiles, lfiles, kfile = self.sequences[idx]
        colors = np.stack([self._load_color(f) for f in cfiles])
        output = []
        if self.channels_first:
            colors = datautils.channels_first(colors)
        output.append(colors)

        if self.return_depth:
            depths = np.stack([self._load_depth(f) for f in dfiles])
            if self.channels_first:
                depths = datautils.channels_first(depths)
            output.append(depths)

        if self.return_intrinsics:
            K = np.loadtxt(kfile).astype(np.float32)
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K[:3, :3]
            raw_h, raw_w = self._RAW_H, self._RAW_W
            K4 = datautils.scale_intrinsics(
                K4, self.height / raw_h, self.width / raw_w
            )
            output.append(K4[None])

        if self.return_pose or self.return_transform:
            poses = np.stack(
                [np.loadtxt(f).astype(np.float32) for f in pfiles]
            )
            poses = np.einsum(
                "ij,ljk->lik", np.linalg.inv(poses[0]), poses
            ).astype(np.float32)
        if self.return_pose:
            output.append(poses)
        if self.return_transform:
            output.append(datautils.poses_to_transforms(poses))
        if self.return_names:
            output.append(name)
        if self.return_labels and lfiles:
            labels = np.stack([self._load_label(f) for f in lfiles])
            output.append(labels)
        return tuple(output)
