"""The gradient through the arena's compaction: the port's
``slam_sequence_compacted`` against ``jax.grad`` of the JAX package's
(mirrors tests/slam/test_lifecycle.py::TestCompactedGrad).

The golden clip at 30x40, B=1, L=6, projective gradICP, compaction (a voxel
merge of 2**-6 m, a power of two so XLA's reciprocal multiply and the port's
division agree) at every second frame. Tolerance: 2.6e-5 of JAX's largest
gradient.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu.slam import lifecycle as JL
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.slam import lifecycle as TL

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"


def _clip(ds, L):
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    idx = [i % colors.shape[1] for i in range(L)]
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= ds
    return (
        np.ascontiguousarray(colors[:1, idx, ::ds, ::ds]),
        np.ascontiguousarray(depths[:1, idx, ::ds, ::ds]),
        K[:1],
    )


class TestCompactedGrad:
    def test_grad_through_compaction_matches_jax(self):
        """The gradient of the pose loss with respect to the depth maps
        through ``slam_sequence_compacted`` (compactions at frames 2 and 4),
        against jax.grad: within 2.6e-5 of JAX's largest value, nonzero on
        every frame after the first."""
        c, d, K = _clip(4, 6)
        H, W = c.shape[2:4]
        kw = dict(odom="gradicp", numiters=4, dsratio=4, fusion=True, assoc="projective")
        lkw = dict(segment_len=2, policy="voxel", voxel_size=2.0**-6)
        cap = 2 * H * W

        def jloss(dj):
            _, poses, _ = JL.slam_sequence_compacted(jnp.asarray(c), dj, jnp.asarray(K), None,
                                                     JS.SLAMOptions(**kw), cap, **lkw)
            return jnp.sum(poses[..., :3, 3] ** 2)

        gj = np.asarray(jax.grad(jloss)(jnp.asarray(d)))
        dt = torch.from_numpy(d).requires_grad_(True)
        _, poses, _ = TL.slam_sequence_compacted(torch.from_numpy(c), dt, torch.from_numpy(K), None,
                                                 TS.SLAMOptions(**kw), cap, **lkw)
        (poses[..., :3, 3] ** 2).sum().backward()
        gt = dt.grad.numpy()
        assert np.isfinite(gt).all()
        per_frame = np.abs(gt).reshape(gt.shape[1], -1).sum(axis=1)
        assert (per_frame[1:] > 0).all(), per_frame
        assert np.abs(gt - gj).max() <= 2.6e-5 * np.abs(gj).max(), np.abs(gt - gj).max() / np.abs(gj).max()
