"""The port's voxel merge against the JAX package's and a numpy oracle
(mirrors tests/ops/test_voxel.py).

Integer outputs (cell counts, validity) are equal to JAX's; merged floats
within atol 1e-6 (measured 1.2e-7: XLA's CPU backend contracts and
reorders the last divide differently). Parity inputs keep every point at
least 1e-3 of a cell from a cell face: XLA divides by a constant voxel size as
a multiply by its float32 reciprocal, which moves a point within one ulp of a
face to the other cell, while the port divides (held against numpy's
division below). A float64 gradcheck covers the backward, including the
guarded square root at a zero normal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.ops.voxel import voxel_merge as j_voxel_merge
from gradslam_tpu.ops.voxel import voxel_merge_rows as j_voxel_merge_rows
from gradslam_tpu.structures.maparena import MapState as JMapState
from gradslam_tpu.structures.maparena import voxel_compact_map as j_voxel_compact_map
from gradslam_tpu_torch.ops.voxel import voxel_merge, voxel_merge_rows
from gradslam_tpu_torch.structures.maparena import MapState, pack_rows, voxel_compact_map

torch.set_num_threads(2)


def _numpy_voxel_oracle(pts, nrm, col, cc, live, voxel):
    """Dict-based reference merge (ccount-weighted, normals renormalized)."""
    cells = {}
    for i in range(len(pts)):
        if not live[i]:
            continue
        key = tuple(np.floor(pts[i] / voxel).astype(np.int64))
        p, n, c, w = cells.get(key, (0.0, 0.0, 0.0, 0.0))
        cells[key] = (p + cc[i, 0] * pts[i], n + cc[i, 0] * nrm[i], c + cc[i, 0] * col[i], w + cc[i, 0])
    out = []
    for p, n, c, w in cells.values():
        n = n / w
        nn = np.linalg.norm(n)
        out.append((p / w, n / nn if nn > 0 else n, c / w, w))
    return out


def _rows(rng, B, N, spread=1.0, voxel=None):
    """Random packed rows; with ``voxel``, every point at least 1e-3 of a
    cell from a cell face (the parity inputs)."""
    pts = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    if voxel is not None:
        frac = pts / voxel - np.floor(pts / voxel)
        pts = np.where(np.minimum(frac, 1 - frac) < 1e-3, pts + np.float32(0.01 * voxel), pts)
        pts = pts.astype(np.float32)
    rows = np.zeros((B, N, 12), np.float32)
    rows[..., 0:3] = pts
    nrm = rng.randn(B, N, 3).astype(np.float32)
    rows[..., 3:6] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    rows[..., 6:9] = rng.uniform(0, 1, (B, N, 3))
    rows[..., 9] = rng.uniform(0.1, 2.0, (B, N))
    rows[..., 10:12] = rng.uniform(0, 5, (B, N, 2))
    live = rng.rand(B, N) > 0.2
    return rows, live


def _split(a):
    return [a[..., 0:3], a[..., 3:6], a[..., 6:9], a[..., 9:10]]


class TestVoxelMerge:
    def test_matches_numpy_oracle(self):
        rng = np.random.RandomState(0)
        rows, live = _rows(rng, 1, 257)
        pts, nrm, col, cc = (x[0] for x in _split(rows))
        voxel = 0.25
        mp, mn, mc, mcc, mlive = voxel_merge(*(torch.from_numpy(x) for x in _split(rows)), torch.from_numpy(live),
                                             voxel)
        got_n = int(mlive[0].sum())
        oracle = _numpy_voxel_oracle(pts, nrm, col, cc, live[0], voxel)
        assert got_n == len(oracle)
        got = mp[0][:got_n].numpy()
        want = np.array([o[0] for o in oracle])
        gi, wi = np.lexsort(got.T), np.lexsort(want.T)
        np.testing.assert_allclose(got[gi], want[wi], atol=1e-5)
        np.testing.assert_allclose(mcc[0][:got_n, 0].numpy()[gi], np.array([o[3] for o in oracle])[wi], atol=1e-5)
        np.testing.assert_allclose(mn[0][:got_n].numpy()[gi], np.array([o[1] for o in oracle])[wi], atol=1e-4)

    def test_distinct_points_pass_through(self):
        pts = np.array([[0.0, 0, 0], [5, 0, 0], [0, 5, 0]], np.float32)
        args = [pts, np.tile([0, 0, 1.0], (3, 1)), np.eye(3), np.ones((3, 1)), np.ones(3, bool)]
        mp, mn, mc, mcc, mlive = voxel_merge(*(torch.from_numpy(np.asarray(a))[None] for a in args), 0.1)
        assert int(mlive[0].sum()) == 3
        got = mp[0][:3].numpy()
        np.testing.assert_array_equal(got[np.lexsort(got.T)], pts[np.lexsort(pts.T)])

    def test_duplicates_collapse_weighted(self):
        pts = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02]], np.float32)
        cc = np.array([[1.0], [3.0]], np.float32)
        col = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        args = [pts, np.tile([0, 0, 1.0], (2, 1)).astype(np.float32), col, cc, np.ones(2, bool)]
        mp, mn, mc, mcc, mlive = voxel_merge(*(torch.from_numpy(a)[None] for a in args), 0.1)
        assert int(mlive[0].sum()) == 1
        np.testing.assert_allclose(mp[0][0].numpy(), (pts[0] + 3 * pts[1]) / 4, atol=1e-7)
        assert float(mcc[0][0, 0]) == 4.0
        np.testing.assert_allclose(mc[0][0].numpy(), [0.25, 0.75, 0.0], atol=1e-7)

    def test_all_dead(self):
        z = torch.zeros
        mp, mn, mc, mcc, mlive = voxel_merge(z(1, 4, 3), z(1, 4, 3), z(1, 4, 3), z(1, 4, 1),
                                             z((1, 4), dtype=torch.bool), 0.1)
        assert int(mlive.sum()) == 0
        assert float(mp.abs().sum()) == 0.0

    def test_negative_coords_cell_boundaries(self):
        pts = np.array([[-0.05, 0, 0], [0.05, 0, 0]], np.float32)
        args = [pts, np.tile([0, 0, 1.0], (2, 1)).astype(np.float32), np.zeros((2, 3), np.float32),
                np.ones((2, 1), np.float32), np.ones(2, bool)]
        *_, mlive = voxel_merge(*(torch.from_numpy(a)[None] for a in args), 0.1)
        assert int(mlive[0].sum()) == 2

    def test_batched_rows_zero_past_the_cells(self):
        rng = np.random.RandomState(1)
        rows, live = _rows(rng, 3, 64)
        merged, mlive = voxel_merge_rows(torch.from_numpy(rows), torch.from_numpy(live), 0.5)
        assert merged.shape == rows.shape
        assert float(torch.where(mlive[..., None], 0.0, merged).abs().sum()) == 0.0
        assert float(merged[..., 10:].abs().sum()) == 0.0  # labels do not survive a merge

    def test_cells_by_true_division(self):
        """Points one ulp around cell faces of a voxel size that is not a
        power of two land where ``floor(p / voxel)`` puts them (numpy's
        division), not where a multiply by the reciprocal would."""
        voxel = np.float32(0.002)
        k = np.arange(1, 2000, dtype=np.float32)
        faces = (k * voxel).astype(np.float32)
        pts = np.concatenate([faces, np.nextafter(faces, 0), np.nextafter(faces, 1)])
        recip = np.floor(pts * (np.float32(1) / voxel))
        div = np.floor(pts / voxel)
        assert (recip != div).any()  # the inputs do tell the two apart
        p3 = np.stack([pts, np.zeros_like(pts), np.zeros_like(pts)], -1)[None]
        rows = pack_rows(torch.from_numpy(p3), torch.zeros_like(torch.from_numpy(p3)),
                         torch.zeros_like(torch.from_numpy(p3)), torch.ones(p3.shape[:2] + (1,)))
        merged, mlive = voxel_merge_rows(rows, torch.ones(p3.shape[:2], dtype=torch.bool), float(voxel))
        assert int(mlive.sum()) == len(np.unique(div))

    @pytest.mark.parametrize("voxel", [0.25, 2.0**-5, 0.07])
    def test_matches_jax(self, voxel):
        rng = np.random.RandomState(2)
        rows, live = _rows(rng, 2, 1500, voxel=voxel)
        jm, jl = j_voxel_merge_rows(jnp.asarray(rows), jnp.asarray(live), voxel)
        tm, tl = voxel_merge_rows(torch.from_numpy(rows), torch.from_numpy(live), voxel)
        assert np.array_equal(tl.numpy(), np.asarray(jl))
        assert int(tl.sum()) < int(live.sum())  # cells did merge
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
        parts_j = j_voxel_merge(*(jnp.asarray(x) for x in _split(rows)), jnp.asarray(live), voxel)
        parts_t = voxel_merge(*(torch.from_numpy(x) for x in _split(rows)), torch.from_numpy(live), voxel)
        for pj, pt in zip(parts_j, parts_t):
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)

    def test_voxel_compact_map_matches_jax(self):
        rng = np.random.RandomState(3)
        rows, _ = _rows(rng, 2, 800, spread=0.3, voxel=2.0**-5)
        n = np.array([700, 523], np.int32)
        jm = j_voxel_compact_map(JMapState(jnp.asarray(rows), jnp.asarray(n)), 2.0**-5)
        tm = voxel_compact_map(MapState(torch.from_numpy(rows), torch.from_numpy(n)), 2.0**-5)
        assert np.array_equal(tm.num_points.numpy(), np.asarray(jm.num_points))
        assert tm.num_points.dtype == torch.int32
        assert (tm.num_points.numpy() < n).all()
        np.testing.assert_allclose(tm.data.numpy(), np.asarray(jm.data), rtol=0, atol=1e-6)

    @staticmethod
    def _cells(second_normal):
        """Five float64 points in three cells of 0.25 (the last one dead);
        the second cell's two normals are (0, 1, 0) and ``second_normal``."""
        pts = torch.tensor([[0.01, 0.01, 0.01], [0.03, 0.02, 0.01], [0.31, 0.02, 0.01], [0.33, 0.04, 0.02],
                            [0.52, 0.5, 0.5]], dtype=torch.float64)
        nrm = torch.tensor([[0, 0, 1.0], [0.1, 0, 0.9], [0, 1.0, 0], second_normal, [1.0, 0, 0]],
                           dtype=torch.float64)
        col = torch.rand(5, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
        cc = torch.tensor([[1.0], [2.0], [1.5], [1.5], [0.5]], dtype=torch.float64)
        live = torch.tensor([[True, True, True, True, False]])

        def f(p, n, c, w):
            merged, _ = voxel_merge_rows(pack_rows(p[None], n[None], c[None], w[None]), live, 0.25)
            return merged[..., :10]

        return f, tuple(x.clone().requires_grad_(True) for x in (pts, nrm, col, cc))

    def test_float64_gradcheck(self):
        """Central differences in float64 through the sort gathers, the
        segmented scan and the normalization."""
        f, inputs = self._cells([0.2, 0.9, 0.1])
        assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-7)

    def test_zero_normal_gradient_is_finite(self):
        """Opposing normals cancel in a cell: the merged normal is exactly
        zero (not differentiable there), and the guarded square root keeps
        every gradient finite instead of 0/0."""
        f, inputs = self._cells([0, -1.0, 0])
        merged = f(*inputs)
        assert float(merged[0, 1, 3:6].detach().abs().sum()) == 0.0
        merged.sum().backward()
        assert all(torch.isfinite(x.grad).all() for x in inputs)
