"""TUM RGB-D benchmark file helpers (a copy of gradslam_tpu.datasets.tumutils).

Reimplements the association tooling the TUM benchmark ships (and the
reference vendors at gradslam/datasets/tumutils.py): timestamped file
lists and greedy nearest-timestamp association.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple, Union

import numpy as np

__all__ = ["read_trajectory", "read_file_list", "associate", "transform44"]


def transform44(row) -> np.ndarray:
    """(stamp, tx, ty, tz, qx, qy, qz, qw) -> 4x4 homogeneous matrix.

    Quaternions below machine norm produce a pure translation (reference
    tumutils.py:57-92 semantics).
    """
    t = np.asarray(row[1:4], dtype=np.float64)
    q = np.asarray(row[4:8], dtype=np.float64)
    T = np.eye(4, dtype=np.float64)
    T[:3, 3] = t
    nq = float(q @ q)
    if nq < np.finfo(np.float64).eps:
        return T
    x, y, z, w = q * np.sqrt(2.0 / nq)
    # outer-product form of the unit-quaternion rotation matrix
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    T[:3, :3] = np.array(
        [
            [1.0 - yy - zz, xy - wz, xz + wy],
            [xy + wz, 1.0 - xx - zz, yz - wx],
            [xz - wy, yz + wx, 1.0 - xx - yy],
        ]
    )
    return T


def read_trajectory(
    filename: str, matrix: bool = True
) -> Dict[str, Union[np.ndarray, List[float]]]:
    """Read a TUM trajectory file into {stamp: pose}.

    Stamps are kept as strings (reference tumutils.py:95-143). With
    ``matrix=True`` poses are 4x4 float64 matrices; otherwise the raw
    ``[tx, ty, tz, qx, qy, qz, qw]`` values. Lines whose quaternion is
    all-zero are dropped; lines containing NaNs are dropped with a
    warning on stderr.
    """
    with open(filename) as f:
        text = f.read()
    rows = []
    for line in text.replace(",", " ").replace("\t", " ").split("\n"):
        if not line or line[0] == "#":
            continue
        parts = [p for p in line.split(" ") if p.strip()]
        if parts:
            rows.append([parts[0]] + [float(v) for v in parts[1:]])
    traj: Dict[str, Union[np.ndarray, List[float]]] = {}
    for i, row in enumerate(rows):
        if row[4:8] == [0.0, 0.0, 0.0, 0.0]:
            continue
        if any(np.isnan(v) for v in row[1:]):
            sys.stderr.write(
                "Warning: line %d of file '%s' has NaNs, skipping line\n" % (i, filename)
            )
            continue
        traj[row[0]] = transform44(row) if matrix else row[1:8]
    return traj


def read_file_list(filename: str) -> Dict[float, List[str]]:
    """Reads a TUM-format file of ``timestamp data...`` lines.

    Lines starting with '#' are comments. Returns {timestamp: [data...]}.
    """
    with open(filename) as f:
        text = f.read()
    out = {}
    for line in text.replace(",", " ").replace("\t", " ").split("\n"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p for p in line.split(" ") if p]
        if len(parts) > 1:
            out[float(parts[0])] = parts[1:]
    return out


def associate(
    first_list: Dict[float, List[str]],
    second_list: Dict[float, List[str]],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """Greedy nearest-timestamp association between two stamped lists.

    All candidate pairs within ``max_difference`` are sorted by |dt| and
    taken greedily, each timestamp used at most once — same algorithm as
    the TUM benchmark's associate.py (reference tumutils.py:182).
    """
    first_keys = set(first_list.keys())
    second_keys = set(second_list.keys())
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches
