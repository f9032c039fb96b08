"""ICL-NUIM dataset loader (host-side numpy; the JAX
package's loader, decoding through :mod:`.imagefile`).

Parity surface with the reference loader (gradslam/datasets/icl.py:17):
TUM-compatible PNG flavor driven by ``associations.txt`` plus
``*.gt.sim`` pose files (3x4 rows), ICL intrinsics (fx=481.20,
fy=-480.0 — negative per dataset convention), depth scale 5000, same
windowing and first-frame pose rebasing as TUM.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np

from . import datautils, imagefile

__all__ = ["ICL"]


class ICL:
    """Dataset of ICL-NUIM RGB-D frame sequences.

    Expects per-trajectory directories containing ``associations.txt``
    (lines: ``ts_depth depth/path ts_rgb rgb/path``) and a ``*.gt.sim``
    pose file of 3x4 matrix rows separated by blank lines.

    Args/ returns: same scheme as :class:`.tum.TUM`.
    """

    _FX, _FY, _CX, _CY = 481.20, -480.0, 319.5, 239.5
    _DEPTH_SCALE = 5000.0
    _RAW_H, _RAW_W = 480, 640

    def __init__(
        self,
        basedir: str,
        trajectories: Union[tuple, str, None] = None,
        seqlen: int = 4,
        dilation: Optional[int] = None,
        stride: Optional[int] = None,
        start: Optional[int] = None,
        end: Optional[int] = None,
        height: int = 480,
        width: int = 640,
        channels_first: bool = False,
        normalize_color: bool = False,
        *,
        return_depth: bool = True,
        return_intrinsics: bool = True,
        return_pose: bool = True,
        return_transform: bool = True,
        return_names: bool = True,
        return_timestamps: bool = False,
        use_native: Optional[bool] = None,
    ):
        basedir = Path(basedir)
        if not basedir.is_dir():
            raise ValueError(f"basedir {basedir} does not exist")
        dilation = 0 if dilation is None else dilation
        stride = seqlen * (dilation + 1) if stride is None else stride
        start = 0 if start is None else start
        if end is not None and end <= start:
            raise ValueError(f"end ({end}) must be greater than start ({start})")

        self.seqlen = seqlen
        self.height = height
        self.width = width
        self.channels_first = channels_first
        self.normalize_color = normalize_color
        self.return_depth = return_depth
        self.return_intrinsics = return_intrinsics
        self.return_pose = return_pose
        self.return_transform = return_transform
        self.return_names = return_names
        self.return_timestamps = return_timestamps
        if use_native is None:
            from . import native_loader

            use_native = native_loader.native_available()
        self.use_native = use_native

        traj_names = self._resolve_trajectories(basedir, trajectories)

        self.samples = []
        for name in traj_names:
            trajdir = basedir / name
            frames = self._load_trajectory(trajdir)
            idx = np.arange(seqlen) * (dilation + 1)
            e = len(frames) if end is None else min(end, len(frames))
            for first in range(start, e, stride):
                window = idx + first
                if window[-1] >= e:
                    break
                self.samples.append((name, [frames[i] for i in window]))
        if not self.samples:
            raise ValueError(
                "no sequences extracted — check seqlen/dilation/stride/start/end"
            )

        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (
            self._FX,
            self._FY,
            self._CX,
            self._CY,
        )
        self.intrinsics = datautils.scale_intrinsics(
            K, height / self._RAW_H, width / self._RAW_W
        )[None]

    @staticmethod
    def _resolve_trajectories(basedir: Path, trajectories):
        available = sorted(
            d.name
            for d in basedir.iterdir()
            if d.is_dir() and (d / "associations.txt").exists()
        )
        if trajectories is None:
            return available
        if isinstance(trajectories, str):
            with open(trajectories) as f:
                wanted = [l.strip() for l in f if l.strip()]
        else:
            wanted = list(trajectories)
        missing = set(wanted) - set(available)
        if missing:
            raise ValueError(
                f"trajectories not found in {basedir}: {missing}"
            )
        return wanted

    @staticmethod
    def _read_gt_sim(path: Path):
        """Parses a ``*.gt.sim`` file of 3x4 pose rows into (N, 4, 4)."""
        poses = []
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rows.append([float(x) for x in line.split()])
                if len(rows) == 3:
                    mat = np.eye(4, dtype=np.float32)
                    mat[:3, :4] = np.asarray(rows, dtype=np.float32)
                    poses.append(mat)
                    rows = []
        return np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32)

    def _load_trajectory(self, trajdir: Path):
        assoc = []
        with open(trajdir / "associations.txt") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 4:
                    # ts_depth depth_path ts_rgb rgb_path
                    assoc.append((parts[1], parts[3]))
        sim_files = sorted(trajdir.glob("*.gt.sim"))
        poses = None
        if sim_files:
            poses = self._read_gt_sim(sim_files[0])
            # ICL quirk: trajectory 0 pose file may miss the last frame
            # (reference icl.py:313-315 drops it)
            if len(poses) == len(assoc) - 1:
                assoc = assoc[:-1]
        else:
            warnings.warn(f"no *.gt.sim file in {trajdir}; poses disabled")
        frames = []
        for i, (dpath, cpath) in enumerate(assoc):
            pose = poses[i] if poses is not None and i < len(poses) else None
            frames.append(
                (str(trajdir / cpath), str(trajdir / dpath), pose)
            )
        return frames

    def __len__(self):
        return len(self.samples)

    @property
    def decode_route(self) -> str:
        """How frames are decoded: 'native' (the C++ loader), else the
        Python path's route (:func:`.imagefile.python_route`)."""
        from . import native_loader

        if self.use_native and native_loader.native_available():
            return "native"
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

    def _load_frames(self, frames):
        """Batch-loads colors (+depths); native C++ threaded path when
        available, Python fallback otherwise."""
        if self.use_native:
            from . import native_loader

            colors = native_loader.load_color_batch(
                [f[0] for f in frames],
                self.height,
                self.width,
                normalize=self.normalize_color,
            )
            depths = (
                native_loader.load_depth_batch(
                    [f[1] for f in frames],
                    self.height,
                    self.width,
                    self._DEPTH_SCALE,
                )
                if self.return_depth
                else None
            )
            if colors is not None:
                return colors, depths
        colors = np.stack([self._load_color(f[0]) for f in frames])
        depths = (
            np.stack([self._load_depth(f[1]) for f in frames])
            if self.return_depth
            else None
        )
        return colors, depths

    def __getitem__(self, idx):
        name, frames = self.samples[idx]
        colors, depths = self._load_frames(frames)
        output = []
        if self.channels_first:
            colors = datautils.channels_first(colors)
        output.append(colors)

        if self.return_depth:
            if self.channels_first:
                depths = datautils.channels_first(depths)
            output.append(depths)

        if self.return_intrinsics:
            output.append(self.intrinsics.copy())

        if self.return_pose or self.return_transform:
            if frames[0][2] is None:
                raise ValueError(f"trajectory {name} has no poses")
            poses = np.stack([f[2] for f in frames])
            poses = np.einsum(
                "ij,ljk->lik", np.linalg.inv(poses[0]), poses
            ).astype(np.float32)
        if self.return_pose:
            output.append(poses)
        if self.return_transform:
            output.append(datautils.poses_to_transforms(poses))
        if self.return_names:
            output.append(name)
        return tuple(output)
