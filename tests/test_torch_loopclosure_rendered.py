"""Loop closure of a rendered trajectory by the port and by the JAX
package (the loop of chip_smoke.py's full-width phase, at 120x160).

100 frames of ``render_loop_sequence`` (radius 0.55, depth noise 0.002) run
through the port's frame-to-frame ``ICPSLAM`` on the CPU; that trajectory
is closed with the pose detector alone and with both detectors (the loop
benchmark's gates, ``close_loops``' defaults otherwise) by both packages:
the same candidates and acceptance weights, the same descriptors within
1e-5, and refined poses within 1e-5. At this size the appearance detector
accepts pairs 28-54 frames apart as well as the closing pairs.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gradslam_tpu.slam import loopclosure as JL
from gradslam_tpu_torch import ICPSLAM, RGBDImages
from gradslam_tpu_torch.datasets.synth import render_loop_sequence
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.slam import (
    close_loops_batched,
    close_loops_rgbd,
    frame_clouds_from_rgbd,
    keyframe_descriptors_invariant,
)

torch.set_num_threads(2)

TOL = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


class TestRenderedLoop:
    def test_both_detectors_on_the_rendered_loop_match_jax(self):
        """Prints the ATE without closure and with each detector set, and
        the accepted pairs."""
        c, d, K, gt = render_loop_sequence(n_frames=100, H=120, W=160, radius=0.55, depth_noise=0.002)
        rgbd = RGBDImages(*_t(c, d, K), device="cpu")
        _, poses = ICPSLAM(odom_targets="recent", device="cpu")(rgbd)
        gates = dict(min_separation=25, max_distance=0.36)
        ate = {"none": float(ate_rmse(poses[0], torch.from_numpy(gt[0])))}
        for det in ("pose", "both"):
            got = close_loops_rgbd(*_t(c, d, K), poses, detection=det, **gates)
            ref = JL.close_loops_rgbd(*(jnp.asarray(x) for x in (c, d, K, poses.numpy())), detection=det, **gates)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
            ate[det] = float(ate_rmse(got[0], torch.from_numpy(gt[0])))
        pts, nrm, val, _, _ = frame_clouds_from_rgbd(*_t(d, K), 4)
        desc = keyframe_descriptors_invariant(pts, nrm, val)
        _, cand, w = close_loops_batched(poses, pts, nrm, val, detection="both", descriptors=desc, **gates)
        jpts, jnrm, jval, _, _ = JL.frame_clouds_from_rgbd(jnp.asarray(d), jnp.asarray(K), 4)
        jdesc = JL.keyframe_descriptors_invariant(jpts[0], jnrm[0], jval[0])[None]
        np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=TOL)
        _, jcand, jw = JL.close_loops_batched(jnp.asarray(poses.numpy()), jpts, jnrm, jval, detection="both",
                                              descriptors=jdesc, **gates)
        np.testing.assert_array_equal(cand.edges.numpy(), np.asarray(jcand.edges))
        np.testing.assert_array_equal(cand.valid.numpy(), np.asarray(jcand.valid))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        accepted = cand.edges[0][w[0] > 0]
        assert bool(((accepted[:, 1] - accepted[:, 0]) < 90).any()), "no pair other than the closing ones"
        print(f"rendered loop 120x160: ATE {ate}, accepted {accepted.tolist()}")
