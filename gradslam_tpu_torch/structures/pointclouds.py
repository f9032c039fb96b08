"""Batched pointclouds (PyTorch port of gradslam_tpu.structures.pointclouds).

Only the padded form (plus per-cloud counts) lives on the device; the list
view is a host-boundary convenience. Operators return new
:class:`Pointclouds` (the reference's trailing-underscore names are aliases
of them); the padded setters are the one in-place change. Plotting and
open3d export go through :mod:`gradslam_tpu_torch.viz`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..geometry import project_points, transform_normals, transform_pointcloud
from ..geometry.projutils import homogenize_points
from .structutils import list_to_padded

__all__ = ["Pointclouds"]


def _pad_list(tensors: Sequence[torch.Tensor], feat_dim: Optional[int] = None):
    """Stacks a list of (N_b, C) tensors into (B, maxN, C) + int32 counts."""
    for t in tensors:
        if t.dim() != 2:
            raise ValueError(f"each element must be 2D (N, C), got shape {tuple(t.shape)}")
    if feat_dim is not None and any(t.shape[1] != feat_dim for t in tensors):
        raise ValueError(f"expected last dim {feat_dim}")
    device = tensors[0].device if len(tensors) else None
    counts = torch.tensor([t.shape[0] for t in tensors], dtype=torch.int32, device=device)
    return list_to_padded([t.float() for t in tensors]), counts


class Pointclouds:
    """A batch of B variable-length pointclouds with optional attributes.

    Stores points/normals/colors as (B, N, 3) and features as (B, N, C)
    zero-padded tensors plus (B,) int32 counts. Construct from a list of
    per-cloud tensors, or from padded tensors with explicit ``num_points``.
    """

    def __init__(
        self,
        points=None,
        normals=None,
        colors=None,
        features=None,
        *,
        num_points=None,
    ):
        if points is None:
            self._points = torch.zeros((0, 0, 3))
            self._normals = self._colors = self._features = None
            self._num_points = torch.zeros((0,), dtype=torch.int32)
            return
        if isinstance(points, (list, tuple)):
            if num_points is not None:
                raise ValueError("num_points only valid with padded input")
            self._points, self._num_points = _pad_list(points, 3)
            cap = self._points.shape[1]

            def _opt(x, dim):
                if x is None:
                    return None
                arr, c2 = _pad_list(x, dim)
                if arr.shape[1] != cap:
                    arr = torch.nn.functional.pad(arr, (0, 0, 0, cap - arr.shape[1]))
                if not torch.equal(c2, self._num_points):
                    raise ValueError("attribute counts must match point counts")
                return arr

            self._normals = _opt(normals, 3)
            self._colors = _opt(colors, 3)
            self._features = _opt(features, None)
            return
        if points.dim() != 3 or points.shape[-1] != 3:
            raise ValueError(f"padded points must be (B, N, 3), got {tuple(points.shape)}")
        B, N = points.shape[:2]
        self._points = points
        if num_points is None:
            num_points = torch.full((B,), N, dtype=torch.int32, device=points.device)
        self._num_points = torch.as_tensor(num_points, dtype=torch.int32, device=points.device)

        def _chk(x, name):
            if x is not None and tuple(x.shape[:2]) != (B, N):
                raise ValueError(f"{name} must be ({B}, {N}, C), got {tuple(x.shape)}")
            return x

        self._normals = _chk(normals, "normals")
        self._colors = _chk(colors, "colors")
        self._features = _chk(features, "features")

    @classmethod
    def _from_padded(cls, points, normals, colors, features, num_points):
        out = cls.__new__(cls)
        out._points = points
        out._normals = normals
        out._colors = colors
        out._features = features
        out._num_points = num_points
        return out

    def _map(self, fn):
        """A new Pointclouds with ``fn`` applied to every tensor."""
        app = lambda x: None if x is None else fn(x)
        return Pointclouds._from_padded(
            app(self._points), app(self._normals), app(self._colors),
            app(self._features), app(self._num_points),
        )

    # -- basic queries ---------------------------------------------------
    def __len__(self):
        return self._points.shape[0]

    @property
    def device(self) -> torch.device:
        return self._points.device

    @property
    def capacity(self):
        return self._points.shape[1]

    @property
    def has_points(self):
        return len(self) > 0 and bool((self._num_points > 0).any())

    @property
    def has_normals(self):
        return self._normals is not None

    @property
    def has_colors(self):
        return self._colors is not None

    @property
    def has_features(self):
        return self._features is not None

    @property
    def equisized(self):
        """True when every cloud holds the same number of points."""
        return len(self) == 0 or bool((self._num_points == self._num_points[0]).all())

    @property
    def num_points_per_pointcloud(self):
        return self._num_points

    @property
    def num_features(self):
        return 0 if self._features is None else self._features.shape[-1]

    @property
    def nonpad_mask(self):
        """(B, N) bool mask of valid (non-padding) entries."""
        N = self._points.shape[1]
        idx = torch.arange(N, dtype=torch.int32, device=self.device)
        return idx[None, :] < self._num_points[:, None]

    # -- padded accessors ------------------------------------------------
    @property
    def points_padded(self):
        return self._points

    @property
    def normals_padded(self):
        return self._normals

    @property
    def colors_padded(self):
        return self._colors

    @property
    def features_padded(self):
        return self._features

    def _assert_set_padded(self, value, expect_dim=None):
        """Checks a padded attribute before it is set: (B, N, C) of the
        points' (B, N), C = ``expect_dim`` when given, zero outside
        :attr:`nonpad_mask`."""
        value = torch.as_tensor(value, device=self.device)
        if value.dim() != 3 or tuple(value.shape[:2]) != tuple(self._points.shape[:2]):
            raise ValueError(
                f"padded value must be ({self._points.shape[0]}, {self._points.shape[1]}, C), "
                f"got {tuple(value.shape)}"
            )
        if expect_dim is not None and value.shape[2] != expect_dim:
            raise ValueError(f"expected last dim {expect_dim}, got {value.shape[2]}")
        if bool((value.detach()[~self.nonpad_mask] != 0).any()):
            raise ValueError("padded values must be zero outside nonpad_mask")
        return value

    @points_padded.setter
    def points_padded(self, value):
        self._points = self._assert_set_padded(value, 3)

    @normals_padded.setter
    def normals_padded(self, value):
        self._normals = self._assert_set_padded(value, 3)

    @colors_padded.setter
    def colors_padded(self, value):
        self._colors = self._assert_set_padded(value, 3)

    @features_padded.setter
    def features_padded(self, value):
        self._features = self._assert_set_padded(value)

    # -- list accessors (host boundary) ----------------------------------
    def _to_list(self, padded) -> Optional[List[torch.Tensor]]:
        if padded is None:
            return None
        counts = self._num_points.tolist()
        return [padded[b, : counts[b]] for b in range(len(self))]

    @property
    def points_list(self):
        return self._to_list(self._points)

    @property
    def normals_list(self):
        return self._to_list(self._normals)

    @property
    def colors_list(self):
        return self._to_list(self._colors)

    @property
    def features_list(self):
        return self._to_list(self._features)

    # -- indexing --------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, int):
            index = slice(index, index + 1) if index != -1 else slice(-1, None)
        if not isinstance(index, slice):
            raise IndexError("Pointclouds supports int/slice batch indexing")
        return self._map(lambda x: x[index])

    # -- arithmetic on the points (padding stays zero) --------------------
    def _points_only(self, fn):
        mask = self.nonpad_mask[..., None].to(self._points.dtype)
        return Pointclouds._from_padded(
            fn(self._points) * mask, self._normals, self._colors, self._features, self._num_points
        )

    def _as(self, x):
        return torch.as_tensor(x, dtype=self._points.dtype, device=self.device)

    def offset(self, offset):
        """Adds ``offset`` (a scalar, (3,) or broadcastable) to the points."""
        return self._points_only(lambda p: p + self._as(offset))

    def __add__(self, other):
        return self.offset(other)

    def __sub__(self, other):
        return self.offset(-self._as(other))

    def scale(self, scale):
        """Multiplies the points by ``scale``."""
        return self._points_only(lambda p: p * self._as(scale))

    def __mul__(self, other):
        return self.scale(other)

    def __truediv__(self, other):
        return self.scale(1.0 / self._as(other))

    def __matmul__(self, transform):
        """Post-multiplies the points by a (3, 3) or (4, 4) matrix:
        ``p @ M``, or ``[p, 1] @ T`` cut to three columns."""
        transform = self._as(transform)
        if tuple(transform.shape[-2:]) == (3, 3):
            return self._points_only(lambda p: torch.matmul(p, transform))
        if tuple(transform.shape[-2:]) == (4, 4):
            return self._points_only(lambda p: torch.matmul(homogenize_points(p), transform)[..., :3])
        raise ValueError(f"transform must be (3,3) or (4,4), got {tuple(transform.shape)}")

    # -- rigid transforms ------------------------------------------------
    def rotate(self, rmat):
        """Rotates points and normals by a (3, 3) or (B, 3, 3) matrix."""
        rmat = self._as(rmat)
        if tuple(rmat.shape[-2:]) != (3, 3):
            raise ValueError(f"rmat must be (..., 3, 3), got {tuple(rmat.shape)}")
        if rmat.dim() == 2:
            rmat = rmat[None]
        mask = self.nonpad_mask[..., None].to(self._points.dtype)
        rot = lambda x: torch.einsum("bij,bnj->bni", rmat, x) * mask
        return Pointclouds._from_padded(
            rot(self._points),
            None if self._normals is None else rot(self._normals),
            self._colors, self._features, self._num_points,
        )

    def transform(self, transform: torch.Tensor) -> "Pointclouds":
        """Applies a (4, 4) or (B, 4, 4) rigid transform to the points and
        rotates the normals; padding stays zero."""
        if tuple(transform.shape[-2:]) != (4, 4):
            raise ValueError(f"transform must be (..., 4, 4), got {tuple(transform.shape)}")
        if transform.dim() == 2:
            transform = transform[None]
        mask = self.nonpad_mask[..., None].to(self._points.dtype)
        pts = transform_pointcloud(self._points, transform) * mask
        nrm = (
            None
            if self._normals is None
            else transform_normals(self._normals, transform) * mask
        )
        return Pointclouds._from_padded(
            pts, nrm, self._colors, self._features, self._num_points
        )

    def pinhole_projection(self, intrinsics):
        """Projects the points onto the image plane: each becomes the
        homogeneous pixel ``[u, v, 1]``; padding stays zero."""
        uv = project_points(self._points, self._as(intrinsics))
        return self._points_only(lambda p: homogenize_points(uv))

    # the reference's in-place names, as functional aliases
    rotate_ = rotate
    transform_ = transform
    pinhole_projection_ = pinhole_projection
    offset_ = offset
    scale_ = scale

    # -- append ----------------------------------------------------------
    def append_points(self, other: "Pointclouds") -> "Pointclouds":
        """Appends another batch of pointclouds per batch element.

        The capacity grows to the largest combined count. Attributes present
        in only one input are dropped.
        """
        if len(other) != len(self):
            if len(self) == 0:
                return other.clone()
            raise ValueError(f"batch sizes must match: {len(self)} vs {len(other)}")
        an, bn = self._num_points.tolist(), other._num_points.tolist()
        cap = max((a + b for a, b in zip(an, bn)), default=0)

        def _combine(a, b):
            if a is None or b is None:
                return None
            out = a.new_zeros((len(self), cap, a.shape[-1]))
            for i in range(len(self)):
                out[i, : an[i]] = a[i, : an[i]]
                out[i, an[i] : an[i] + bn[i]] = b[i, : bn[i]]
            return out

        return Pointclouds._from_padded(
            _combine(self._points, other._points),
            _combine(self._normals, other._normals),
            _combine(self._colors, other._colors),
            _combine(self._features, other._features),
            self._num_points + other._num_points,
        )

    # -- clones and device movement --------------------------------------
    def clone(self):
        return self._map(torch.clone)

    def detach(self):
        return self._map(torch.Tensor.detach)

    def astype(self, dtype):
        """The points, normals, colors and features cast to ``dtype``."""
        cast = lambda x: None if x is None else x.to(dtype)
        return Pointclouds._from_padded(
            cast(self._points), cast(self._normals), cast(self._colors), cast(self._features),
            self._num_points,
        )

    def to(self, device):
        """Moves every tensor to ``device``."""
        return self._map(lambda x: x.to(device))

    def cpu(self):
        return self.to("cpu")

    def cuda(self):
        return self.to("cuda")

    # -- viz export ------------------------------------------------------
    def open3d(self, index: int = 0):
        from ..viz import pointclouds_open3d

        return pointclouds_open3d(self, index)

    def plotly(self, index: int = 0, **kwargs):
        from ..viz import pointclouds_plotly

        return pointclouds_plotly(self, index, **kwargs)

    def __repr__(self):
        return (
            f"Pointclouds(B={len(self)}, capacity={self.capacity}, "
            f"num_points={self._num_points.tolist()}, "
            f"normals={self.has_normals}, colors={self.has_colors}, "
            f"features={self.has_features})"
        )
