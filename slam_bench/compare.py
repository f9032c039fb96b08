"""The numbers that decide ``correct``: how far what the timed path produced
lies from the plain reference. Each is a gap, so a smaller number is
closer; a workload file gives each its limit."""

from __future__ import annotations

import math

import torch


def _rotation_deg(R: torch.Tensor) -> torch.Tensor:
    """The angle of a rotation, from its skew part and trace (exact for
    small angles, where the trace alone loses them to rounding)."""
    s = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    c = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0
    return torch.rad2deg(torch.atan2(torch.linalg.vector_norm(s, dim=-1), c))


def pose_gaps(poses: torch.Tensor, ref: torch.Tensor, prefix: str = "pose") -> dict:
    """Widest gap over every (B, L) pose: its translation in metres and the
    angle of the relative rotation in degrees."""
    p, r = poses.detach().double().cpu(), ref.detach().double().cpu()
    dt = torch.linalg.vector_norm(p[..., :3, 3] - r[..., :3, 3], dim=-1).max()
    rel = r[..., :3, :3].transpose(-1, -2) @ p[..., :3, :3]
    return {f"{prefix}_gap_m": float(dt), f"{prefix}_gap_deg": float(_rotation_deg(rel).max())}


def _nearest_rows(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Index of each (S, 3) query's nearest of the (N, 3) rows by exact
    squared distance, a block of queries at a time."""
    chunk = max(1, (1 << 26) // max(1, rows.shape[0]))
    cols = [c.contiguous()[None, :] for c in rows.unbind(-1)]
    out = []
    for block in q.split(chunk):
        d = (block[:, 0:1] - cols[0]) ** 2
        d += (block[:, 1:2] - cols[1]) ** 2
        d += (block[:, 2:3] - cols[2]) ** 2
        out.append(d.argmin(dim=1))
    return torch.cat(out)


def arena_rows(data: torch.Tensor, num_points: torch.Tensor) -> list:
    """Each batch element's live rows ``[point, normal, colour, confidence]``
    of a (B, CAP, >= 10) arena."""
    return [data[b, : int(n), :10] for b, n in enumerate(num_points.tolist())]


def map_gaps(maps, ref_maps, seed: int, samples: int = 4096) -> dict:
    """Maps against the reference's, each a list of (n, 10) rows
    ``[point, normal, colour, confidence]`` a batch element, whatever the
    order of their rows: the count's gap as a share of the reference's, and
    the mean gaps of point (metres), normal, colour (0-255, the channel
    furthest off) and confidence (over the larger of the two, since a
    confidence is a sum of weights that fall fast with depth) between a row
    and its counterpart, the
    other map's row nearest to its point. ``samples`` rows of each map of
    each batch element, drawn from ``seed``, look for their counterparts in
    the other map."""
    out = {"num_points_gap": max(abs(m.shape[0] - r.shape[0]) / max(1, r.shape[0]) for m, r in zip(maps, ref_maps))}
    sums = torch.zeros(4, dtype=torch.float64)
    count = 0
    gen = torch.Generator().manual_seed(seed & 0xFFFFFFFFFFFF)
    for prog, ref_rows in zip(maps, ref_maps):
        prog = prog[:, :10].detach().float()
        ref_rows = ref_rows[:, :10].detach().float().to(prog.device)
        if prog.shape[0] == 0 or ref_rows.shape[0] == 0:
            return dict(out, points_gap_m=math.inf, normals_gap=math.inf, colors_gap=math.inf, conf_gap=math.inf)
        for a, other in ((ref_rows, prog), (prog, ref_rows)):
            pick = torch.randint(a.shape[0], (samples,), generator=gen).to(a.device)
            q = a[pick]
            r = other[_nearest_rows(q[:, 0:3], other[:, 0:3])]
            d = q - r
            sums += torch.stack([torch.linalg.vector_norm(d[:, 0:3], dim=-1).sum(),
                                 torch.linalg.vector_norm(d[:, 3:6], dim=-1).sum(),
                                 d[:, 6:9].abs().amax(dim=-1).sum(),
                                 (d[:, 9].abs() / torch.maximum(q[:, 9].abs(), r[:, 9].abs()).clamp(min=1e-30)).sum()
                                 ]).double().cpu()
            count += samples
    means = (sums / count).tolist()
    out.update(points_gap_m=means[0], normals_gap=means[1], colors_gap=means[2], conf_gap=means[3])
    return out


def median(values) -> float:
    v = sorted(float(x) for x in values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """The widest gap between the program's value of a scalar leaf and the
    reference's, sign included, each over the larger of the reference's
    magnitude of that leaf and of the median leaf's; ``skip`` names leaves
    left out."""
    names = [k for k in ref if k not in skip]
    if not names:
        return 0.0
    med = median(abs(ref[k]) for k in names)
    gaps = []
    for k in names:
        scale = max(abs(float(ref[k])), med)
        gap = abs(float(prog[k]) - float(ref[k]))
        gaps.append(gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf))
    return max(gaps)


def relative_gap(value: float, ref: float) -> float:
    """|value - ref| / |ref| (0 when both are 0)."""
    if ref == 0:
        return 0.0 if value == 0 else math.inf
    return abs(value - ref) / abs(ref)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have a limit:
    each at or below it; one that is missing or not finite fails."""
    rows = [(k, numbers.get(k, math.nan), lim) for k, lim in limits.items()]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
