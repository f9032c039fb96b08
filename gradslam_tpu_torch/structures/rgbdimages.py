"""RGB-D frame structures (PyTorch port of gradslam_tpu.structures.rgbdimages).

The compute core is a set of pure functions over channels-last tensors:
depth (B, L, H, W, 1), color (B, L, H, W, 3), intrinsics (B, 1, 4, 4),
poses (B, L, 4, 4). :class:`RGBDImages` is a container with lazily
computed, cached derived maps on top of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..geometry import create_meshgrid, inverse_intrinsics
from ..geometry.projutils import matvec
from ..utils.device import resolve_device

__all__ = [
    "valid_depth_mask",
    "pixel_rays",
    "compute_vertex_map",
    "compute_global_vertex_map",
    "compute_normal_map",
    "compute_global_normal_map",
    "RGBDImages",
]


def valid_depth_mask(depth_image: torch.Tensor) -> torch.Tensor:
    """Bool mask of pixels with valid (> 0) depth. Shape matches input."""
    return depth_image > 0


def pixel_rays(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid ``[u(col), v(row), 1]`` of shape (H, W, 3)."""
    grid = create_meshgrid(height, width, False, device=device, dtype=dtype)[0]
    return torch.cat([grid[..., 1:2], grid[..., 0:1], torch.ones_like(grid[..., :1])], -1)


def compute_vertex_map(depth_image: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unprojects (B, L, H, W, 1) depth into (B, L, H, W, 3) camera-frame
    vertex maps ``depth * Kinv @ [u, v, 1]``, zero where depth is invalid.
    ``intrinsics`` is (B, 1, 4, 4)."""
    B, L, H, W, _ = depth_image.shape
    rays = pixel_rays(H, W, depth_image.dtype, depth_image.device)
    kinv = inverse_intrinsics(intrinsics)[..., :3, :3]  # (B, 1, 3, 3)
    vmap_rays = matvec(kinv[:, :, None, None], rays)  # (B, 1, H, W, 3)
    vertex = vmap_rays * depth_image
    return vertex * valid_depth_mask(depth_image).to(vertex.dtype)


def compute_global_vertex_map(
    vertex_map: torch.Tensor,
    poses: Optional[torch.Tensor],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """World-frame vertex maps ``R v + t`` for (B, L, 4, 4) poses; pixels
    outside the optional (B, L, H, W, 1) ``mask`` are zero."""
    if poses is None:
        return vertex_map
    out = matvec(poses[:, :, None, None, :3, :3], vertex_map)
    out = out + poses[:, :, None, None, :3, 3]
    if mask is not None:
        out = out * mask.to(out.dtype)
    return out


def compute_normal_map(
    vertex_map: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Normals from (B, L, H, W, 3) vertex maps by forward differences.

    ``n = normalize(cross(d/du v, d/dv v))`` with the last row/column
    replicated. Degenerate pixels get the exact zero normal through a
    relative parallelism test, ``|dh x dv|^2 <= 1e-12 |dh|^2 |dv|^2``: a
    cross product of parallel vectors leaves rounding noise, and a test for
    an exactly zero norm would normalize that noise into a garbage unit
    vector.
    """
    dh = torch.diff(vertex_map, dim=-2)
    dh = torch.cat([dh, dh[..., -1:, :]], dim=-2)
    dv = torch.diff(vertex_map, dim=-3)
    dv = torch.cat([dv, dv[..., -1:, :, :]], dim=-3)
    normal = torch.linalg.cross(dh, dv, dim=-1)
    norm_sq = (normal * normal).sum(-1, keepdim=True)
    dh_sq = (dh * dh).sum(-1, keepdim=True)
    dv_sq = (dv * dv).sum(-1, keepdim=True)
    degenerate = norm_sq <= 1e-12 * dh_sq * dv_sq
    # the argument is guarded BEFORE sqrt: sqrt(0) has an infinite
    # derivative, which would poison the backward pass with NaNs
    norm = torch.sqrt(torch.where(degenerate, torch.ones_like(norm_sq), norm_sq))
    normal = torch.where(degenerate, torch.zeros_like(normal), normal / norm)
    if mask is not None:
        normal = normal * mask.to(normal.dtype)
    return normal


def compute_global_normal_map(
    normal_map: torch.Tensor, poses: Optional[torch.Tensor]
) -> torch.Tensor:
    """Rotates (B, L, H, W, 3) normal maps into the world frame."""
    if poses is None:
        return normal_map
    return matvec(poses[:, :, None, None, :3, :3], normal_map)


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 1, 3, 4, 2)


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 1, 4, 2, 3)


class RGBDImages:
    """A batch of RGB-D frame sequences.

    Args:
        rgb_image: (B, L, H, W, 3) color (or (B, L, 3, H, W) when
            ``channels_first``); a tensor or an array.
        depth_image: (B, L, H, W, 1) depth (or (B, L, 1, H, W)).
        intrinsics: (B, 1, 4, 4) pinhole intrinsics.
        poses: optional (B, L, 4, 4) camera-to-world poses.
        channels_first: input (and output) layout flag; storage is always
            channels-last.
        device: where the tensors live; default ``"cuda"`` (raises when no
            CUDA device is present — pass ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        rgb_image,
        depth_image,
        intrinsics,
        poses=None,
        channels_first: bool = False,
        device=None,
    ):
        dev = resolve_device(device)
        as_t = lambda x: torch.as_tensor(x, device=dev)
        rgb_image, depth_image, intrinsics = map(as_t, (rgb_image, depth_image, intrinsics))
        if poses is not None:
            poses = as_t(poses)
        if channels_first:
            rgb_image = _to_channels_last(rgb_image)
            depth_image = _to_channels_last(depth_image)
        if rgb_image.dim() != 5 or rgb_image.shape[-1] != 3:
            raise ValueError(f"rgb_image must be (B, L, H, W, 3), got {tuple(rgb_image.shape)}")
        if depth_image.dim() != 5 or depth_image.shape[-1] != 1:
            raise ValueError(
                f"depth_image must be (B, L, H, W, 1), got {tuple(depth_image.shape)}"
            )
        if depth_image.shape[:4] != rgb_image.shape[:4]:
            raise ValueError(
                "rgb_image and depth_image batch/seq/spatial dims must match: "
                f"{tuple(rgb_image.shape)} vs {tuple(depth_image.shape)}"
            )
        if intrinsics.dim() != 4 or tuple(intrinsics.shape[-2:]) != (4, 4):
            raise ValueError(f"intrinsics must be (B, 1, 4, 4), got {tuple(intrinsics.shape)}")
        if poses is not None and (poses.dim() != 4 or tuple(poses.shape[-2:]) != (4, 4)):
            raise ValueError(f"poses must be (B, L, 4, 4), got {tuple(poses.shape)}")
        self._rgb = rgb_image
        self._depth = depth_image
        self._intrinsics = intrinsics
        self._poses = poses
        self.channels_first = bool(channels_first)
        self._cache: dict = {}

    def _new(self, rgb, depth, intrinsics, poses):
        return RGBDImages(
            rgb, depth, intrinsics, poses, channels_first=False, device=rgb.device
        )

    # -- shape ----------------------------------------------------------
    @property
    def shape(self):
        B, L, H, W, _ = self._rgb.shape
        return (B, L, H, W)

    def __len__(self):
        return self._rgb.shape[0]

    @property
    def device(self) -> torch.device:
        return self._rgb.device

    @property
    def h(self):
        return self._rgb.shape[2]

    @property
    def w(self):
        return self._rgb.shape[3]

    @property
    def cdim(self):
        """The channel dim in the active layout: 2 channels-first, else 4."""
        return 2 if self.channels_first else 4

    @property
    def pixel_pos(self):
        """(B, L, H, W, 3) homogeneous pixel positions ``[u, v, 1]``, in
        the active layout."""
        B, L, H, W = self.shape
        rays = pixel_rays(H, W, self._rgb.dtype, self.device)
        return self._layout(rays.expand(B, L, H, W, 3))

    # -- raw data -------------------------------------------------------
    def _layout(self, x):
        return _to_channels_first(x) if self.channels_first else x

    @property
    def rgb_image(self):
        return self._layout(self._rgb)

    @property
    def depth_image(self):
        return self._layout(self._depth)

    @property
    def intrinsics(self):
        return self._intrinsics

    @property
    def poses(self):
        return self._poses

    @poses.setter
    def poses(self, value):
        if value is not None:
            value = torch.as_tensor(value, device=self.device)
            if value.dim() != 4 or tuple(value.shape[-2:]) != (4, 4):
                raise ValueError(f"poses must be (B, L, 4, 4), got {tuple(value.shape)}")
        self._poses = value
        self._cache.pop("global_vertex_map", None)
        self._cache.pop("global_normal_map", None)

    @property
    def has_poses(self):
        return self._poses is not None

    # -- derived maps ---------------------------------------------------
    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def valid_depth_mask(self):
        return self._layout(self._cached("valid_depth_mask", lambda: valid_depth_mask(self._depth)))

    def _vertex(self):
        return self._cached(
            "vertex_map", lambda: compute_vertex_map(self._depth, self._intrinsics)
        )

    def _normal(self):
        return self._cached(
            "normal_map",
            lambda: compute_normal_map(self._vertex(), valid_depth_mask(self._depth)),
        )

    @property
    def vertex_map(self):
        return self._layout(self._vertex())

    @property
    def global_vertex_map(self):
        return self._layout(
            self._cached(
                "global_vertex_map",
                lambda: compute_global_vertex_map(
                    self._vertex(), self._poses, valid_depth_mask(self._depth)
                ),
            )
        )

    @property
    def normal_map(self):
        return self._layout(self._normal())

    @property
    def global_normal_map(self):
        return self._layout(
            self._cached(
                "global_normal_map",
                lambda: compute_global_normal_map(self._normal(), self._poses),
            )
        )

    # -- views / conversion --------------------------------------------
    def __getitem__(self, index):
        """Slices over (batch, sequence), preserving dims."""
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) > 2:
            raise IndexError("RGBDImages supports (batch, seq) indexing only")

        def _norm(i, size):
            if isinstance(i, int):
                if i < -size or i >= size:
                    raise IndexError(f"index {i} out of range for size {size}")
                i = i % size
                return slice(i, i + 1)
            return i

        b = _norm(index[0], self._rgb.shape[0])
        s = _norm(index[1], self._rgb.shape[1]) if len(index) == 2 else slice(None)
        return self._new(
            self._rgb[b, s],
            self._depth[b, s],
            self._intrinsics[b],
            None if self._poses is None else self._poses[b, s],
        )

    def to_channels_last(self):
        out = self._new(self._rgb, self._depth, self._intrinsics, self._poses)
        out._cache = dict(self._cache)
        return out

    def to_channels_first(self):
        out = self.to_channels_last()
        out.channels_first = True
        return out

    def to_channels_last_(self):
        """Switches the layout flag in place (storage is channels-last)."""
        self.channels_first = False
        return self

    def to_channels_first_(self):
        """Switches the layout flag in place (storage is channels-last)."""
        self.channels_first = True
        return self

    def _derived(self, fn, keep_cache=False):
        """A new instance of every tensor through ``fn``, in this layout."""
        out = self._new(fn(self._rgb), fn(self._depth), fn(self._intrinsics),
                        None if self._poses is None else fn(self._poses))
        out.channels_first = self.channels_first
        if keep_cache:
            out._cache = dict(self._cache)
        return out

    def astype(self, dtype):
        return self._derived(lambda x: x.to(dtype))

    def detach(self):
        return self._derived(torch.Tensor.detach)

    def clone(self):
        return self._derived(torch.clone, keep_cache=True)

    def to(self, device):
        """Moves every tensor to ``device``."""
        mv = lambda x: None if x is None else x.to(device)
        out = self._new(mv(self._rgb), mv(self._depth), mv(self._intrinsics), mv(self._poses))
        out.channels_first = self.channels_first
        return out

    def cpu(self):
        return self.to("cpu")

    def cuda(self):
        return self.to("cuda")

    def __repr__(self):
        return (
            f"RGBDImages(shape={self.shape}, has_poses={self.has_poses}, "
            f"channels_first={self.channels_first}, device={self.device})"
        )
