"""The frozen renderer: the same seed gives the same inputs, another seed
other content at the same sizes, and the scene is the port's synthetic one."""

import numpy as np
import torch

from slam_bench.inputs import render

ARGS = dict(arcs=2, length=4, H=24, W=32, pinhole=(13.125, 13.125, 15.5, 11.5), n_loop=400, radius=0.55,
            depth_noise=0.002, device="cpu")


def test_a_seed_gives_the_same_inputs_and_another_seed_others():
    big = 2**33 + 12345  # the driver's seeds pass 32 signed bits
    a = render.render_arcs(big, **ARGS)
    b = render.render_arcs(big, **ARGS)
    c = render.render_arcs(big + 1, **ARGS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[3], c[3])
    assert torch.equal(a[2], c[2])  # the pinhole is the configuration's
    assert bool((a[1] > 0).all()) and bool(((a[0] >= 0) & (a[0] <= 255)).all())


def test_arcs_start_at_the_identity_and_move_like_a_hand_held_camera():
    _, _, _, gt = render.render_arcs(7, **ARGS)
    assert torch.allclose(gt[:, 0], torch.eye(4).expand(2, 4, 4), atol=1e-6)
    step = torch.linalg.vector_norm(gt[:, 1:, :3, 3] - gt[:, :-1, :3, 3], dim=-1)
    assert bool(((step > 0.006) & (step < 0.012)).all())  # 2 pi 0.55 / 400 = 8.6 mm a frame


def test_the_scene_is_the_ports_synthetic_loop():
    from gradslam_tpu_torch.datasets import synth

    poses = render.loop_poses(20, 0, 20, 0.55, (0.0, 0.0, 0.0))
    assert np.abs(poses.astype(np.float32) - synth.loop_trajectory(20, radius=0.55)).max() == 0
    K = render.intrinsics(13.125, 13.125, 15.5, 11.5)
    c, d = synth.render_frames(poses[:2].astype(np.float32), 24, 32, (13.125, 13.125, 15.5, 11.5))
    rgb, s = render._ray_cast(poses[:2].astype(np.float32).astype(np.float64), K, 24, 32, "cpu")
    assert np.abs(s.numpy() - d).max() < 1e-5 and np.abs(rgb.numpy() - c).max() < 1e-5
