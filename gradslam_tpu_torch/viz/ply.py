"""Dependency-free PLY export for pointclouds (the JAX package's writer,
byte for byte, with the rows packed by numpy instead of one
``struct.pack`` per point).

A plain binary PLY writer makes map dumps possible on headless hosts with
no viz stack.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["write_ply", "pointclouds_to_ply"]


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_ply(
    path: str,
    points,
    normals=None,
    colors=None,
) -> None:
    """Writes an (N, 3) pointcloud to a binary little-endian PLY file.

    Args:
        points: (N, 3) float positions (numpy or torch).
        normals: optional (N, 3) float normals.
        colors: optional (N, 3) colors in [0, 1] or [0, 255].
    """
    points = _numpy(points).astype(np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {points.shape}")
    n = len(points)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    fields = [("p", "<f4", (3,))]
    values = {"p": points}
    if normals is not None:
        values["n"] = _numpy(normals).astype(np.float32)
        header += [f"property float n{a}" for a in "xyz"]
        fields.append(("n", "<f4", (3,)))
    if colors is not None:
        cols = _numpy(colors).astype(np.float32)
        if cols.size and cols.max() <= 1.5:
            cols = cols * 255.0
        values["c"] = np.clip(cols, 0, 255).astype(np.uint8)
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
        fields.append(("c", "u1", (3,)))
    header.append("end_header")

    rows = np.empty(n, dtype=np.dtype(fields))  # packed: no padding between fields
    for name, value in values.items():
        rows[name] = value
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rows.tobytes())


def pointclouds_to_ply(pointclouds, path: str, index: int = 0) -> None:
    """Exports one batch element of a Pointclouds to a PLY file."""
    pts = pointclouds.points_list[index]
    nrm = pointclouds.normals_list[index] if pointclouds.has_normals else None
    col = pointclouds.colors_list[index] if pointclouds.has_colors else None
    write_ply(path, pts, nrm, col)
