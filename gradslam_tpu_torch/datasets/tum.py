"""TUM RGB-D dataset loader (host-side numpy; the JAX
package's loader, decoding through :mod:`.imagefile`).

Parity surface with the reference loader (gradslam/datasets/tum.py:17):
timestamp association of rgb/depth/groundtruth, sequence windowing with
seqlen/dilation/stride/start/end, fixed freiburg intrinsics scaled for
resize, depth scale 5000, poses rebased so the first frame of every
sequence is identity.

Returns numpy arrays (the host/device boundary): feed them to
``RGBDImages`` directly or through any dataloader.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np

from . import datautils, imagefile
from .tumutils import associate, read_file_list

__all__ = ["TUM"]


class TUM:
    """Dataset of TUM RGB-D frame sequences.

    Args:
        basedir: directory containing extracted TUM sequence folders
            (each with rgb/, depth/, rgb.txt, depth.txt, groundtruth.txt).
        sequences: None (all), a tuple of sequence names, or a path to a
            .txt file listing sequence names.
        seqlen: frames per extracted sequence. Default 4.
        dilation: frames skipped between consecutive extracted frames.
        stride: frames between first frames of consecutive sequences
            (default: non-overlapping, ``seqlen * (dilation + 1)``).
        start / end: frame index range to window over.
        height / width: output spatial size (bilinear color, nearest depth).
        channels_first: return (L, C, H, W) images instead of (L, H, W, C).
        normalize_color: scale colors to [0, 1].
        return_*: toggles for each output element.

    ``__getitem__`` returns, in order (gated by the return flags):
    (colors, depths, intrinsics, poses, transforms, names, timestamps).
    """

    # freiburg default pinhole intrinsics (reference tum.py:338-343)
    _FX, _FY, _CX, _CY = 525.0, 525.0, 319.5, 239.5
    _DEPTH_SCALE = 5000.0
    _RAW_H, _RAW_W = 480, 640

    def __init__(
        self,
        basedir: str,
        sequences: Union[tuple, str, None] = None,
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
        return_timestamps: bool = True,
        use_native: Optional[bool] = None,
    ):
        basedir = Path(basedir)
        if not basedir.is_dir():
            raise ValueError(f"basedir {basedir} does not exist")
        if not isinstance(seqlen, int) or seqlen < 0:
            raise ValueError(f"seqlen must be a positive int, got {seqlen}")
        dilation = 0 if dilation is None else dilation
        stride = seqlen * (dilation + 1) if stride is None else stride
        if dilation < 0 or stride < 0:
            raise ValueError("dilation and stride must be non-negative")
        start = 0 if start is None else start
        if start < 0:
            raise ValueError(f"start must be non-negative, got {start}")
        if end is not None and end <= start:
            raise ValueError(f"end ({end}) must be greater than start ({start})")

        self.seqlen = seqlen
        self.dilation = dilation
        self.stride = stride
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

        seq_names = self._resolve_sequences(basedir, sequences)

        # build per-sequence association and windowing
        self.samples = []  # list of (seq_name, [(t_rgb, rgb, t_d, d, t_p, pose7)])
        for name in seq_names:
            seqdir = basedir / name
            frames = self._associate_sequence(seqdir)
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

        h_ratio = height / self._RAW_H
        w_ratio = width / self._RAW_W
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (
            self._FX,
            self._FY,
            self._CX,
            self._CY,
        )
        self.intrinsics = datautils.scale_intrinsics(K, h_ratio, w_ratio)[
            None
        ]  # (1, 4, 4)

    @staticmethod
    def _resolve_sequences(basedir: Path, sequences):
        available = sorted(
            d.name
            for d in basedir.iterdir()
            if d.is_dir() and (d / "rgb.txt").exists()
        )
        if sequences is None:
            return available
        if isinstance(sequences, str):
            with open(sequences) as f:
                wanted = [l.strip() for l in f if l.strip()]
        else:
            wanted = list(sequences)
        missing = set(wanted) - set(available)
        if missing:
            raise ValueError(f"sequences not found in {basedir}: {missing}")
        return wanted

    def _associate_sequence(self, seqdir: Path):
        """rgb-depth-groundtruth association (reference tum.py:517-569)."""
        rgb_list = read_file_list(str(seqdir / "rgb.txt"))
        depth_list = read_file_list(str(seqdir / "depth.txt"))
        gt_file = seqdir / "groundtruth.txt"
        has_gt = gt_file.exists()
        matches_rd = associate(rgb_list, depth_list, 0.0, 0.02)
        frames = []
        if has_gt:
            gt_list = read_file_list(str(gt_file))
            rgb_only = {t: rgb_list[t] for t, _ in matches_rd}
            matches_rp = dict(associate(rgb_only, gt_list, 0.0, 0.02))
            for t_rgb, t_d in matches_rd:
                if t_rgb not in matches_rp:
                    continue
                t_p = matches_rp[t_rgb]
                pose7 = np.array(
                    [float(x) for x in gt_list[t_p]], dtype=np.float32
                )
                frames.append(
                    (
                        t_rgb,
                        str(seqdir / rgb_list[t_rgb][0]),
                        t_d,
                        str(seqdir / depth_list[t_d][0]),
                        t_p,
                        pose7,
                    )
                )
        else:
            warnings.warn(f"no groundtruth.txt in {seqdir}; poses disabled")
            for t_rgb, t_d in matches_rd:
                frames.append(
                    (
                        t_rgb,
                        str(seqdir / rgb_list[t_rgb][0]),
                        t_d,
                        str(seqdir / depth_list[t_d][0]),
                        np.nan,
                        None,
                    )
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
        """Batch-loads colors (+depths) — native C++ threaded path when
        available (datasets/native_loader.py), Python fallback otherwise."""
        if self.use_native:
            from . import native_loader

            colors = native_loader.load_color_batch(
                [f[1] for f in frames],
                self.height,
                self.width,
                normalize=self.normalize_color,
            )
            depths = (
                native_loader.load_depth_batch(
                    [f[3] for f in frames],
                    self.height,
                    self.width,
                    self._DEPTH_SCALE,
                )
                if self.return_depth
                else None
            )
            if colors is not None:
                return colors, depths
        colors = np.stack([self._load_color(f[1]) for f in frames])
        depths = (
            np.stack([self._load_depth(f[3]) for f in frames])
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

        need_poses = self.return_pose or self.return_transform
        if need_poses:
            if frames[0][5] is None:
                raise ValueError(
                    f"sequence {name} has no groundtruth poses"
                )
            pq = np.stack([f[5] for f in frames])
            poses = datautils.pointquaternion_to_homogeneous(pq)
            # rebase so the first frame is identity (reference tum.py:483-499)
            poses = np.einsum(
                "ij,ljk->lik", np.linalg.inv(poses[0]), poses
            ).astype(np.float32)
        if self.return_pose:
            output.append(poses)
        if self.return_transform:
            output.append(datautils.poses_to_transforms(poses))
        if self.return_names:
            output.append(name)
        if self.return_timestamps:
            stamps = np.array(
                [[f[0], f[2], f[4]] for f in frames], dtype=np.float64
            )
            output.append(stamps)
        return tuple(output)
