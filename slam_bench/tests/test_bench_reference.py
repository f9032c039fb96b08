"""The plain reference against the port on the CPU at a tiny size (B = 1 and
2, L = 3, 24x32): the two are written apart, so they agree to rounding, not
bit for bit; and the reference's own parts on hand-made inputs."""

import math

import pytest
import torch

from slam_bench import compare
from slam_bench import reference as ref
from slam_bench.inputs import render

PINHOLE = (13.125, 13.125, 15.5, 11.5)


def _frames(B, L, seed=5):
    return render.render_arcs(seed, B, L, 24, 32, PINHOLE, 400, 0.55, 0.002, "cpu")


@pytest.mark.parametrize("B", [1, 2])
def test_pointfusion_sequence_agrees_with_the_port(B):
    from gradslam_tpu_torch.slam.icpslam import SLAMOptions, slam_sequence

    c, d, K, _ = _frames(B, 3)
    m, p = slam_sequence(c, d, K, None, SLAMOptions(fusion=True), 3 * 24 * 32)
    rp, maps = ref.sequence(c, d, K, ref.Options(), 3 * 24 * 32)
    g = {**compare.pose_gaps(p, rp), **compare.map_gaps(compare.arena_rows(m.data, m.num_points), maps, 3)}
    assert g["pose_gap_m"] < 1e-4 and g["pose_gap_deg"] < 1e-3 and g["num_points_gap"] == 0
    assert g["points_gap_m"] < 1e-5 and g["normals_gap"] < 1e-4 and g["colors_gap"] < 1e-2 and g["conf_gap"] < 1e-5


def test_incremental_steps_agree_with_the_port():
    from gradslam_tpu_torch.slam.icpslam import SLAMOptions, slam_init_state, slam_step_state

    c, d, K, _ = _frames(1, 3)
    opts = SLAMOptions(fusion=True)
    s = slam_init_state(c[:, 0], d[:, 0], K, opts, 100 * 24 * 32)
    poses = [s.pose]
    for t in (1, 2):
        s = slam_step_state(s, c[:, t], d[:, t], K, opts)
        poses.append(s.pose)
    rp, maps = ref.sequence(c, d, K, ref.Options(), 100 * 24 * 32)
    g = {**compare.pose_gaps(torch.stack(poses, 1), rp), **compare.map_gaps(
        compare.arena_rows(s.map_state.data, s.map_state.num_points), maps, 4)}
    assert g["pose_gap_m"] < 1e-4 and g["num_points_gap"] == 0 and g["points_gap_m"] < 1e-5


def test_the_gradient_agrees_with_the_port():
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss
    from gradslam_tpu_torch.slam.icpslam import SLAMOptions

    c, d, K, gt = _frames(2, 3, seed=9)
    d = d / 1.1
    params = DepthCalibParams(scale=1.0, device="cpu")
    loss = slam_loss(params, c, d, K, gt, SLAMOptions(fusion=True), 3 * 24 * 32)
    g = torch.autograd.grad(loss, [params.scale, params.bias])
    s, b = torch.ones((), requires_grad=True), torch.zeros((), requires_grad=True)
    p, _ = ref.sequence(c, d * s + b * (d > 0), K, ref.Options(), 3 * 24 * 32)
    rloss = ((p[..., :3, 3] - gt[..., :3, 3]) ** 2).mean()
    rg = torch.autograd.grad(rloss, [s, b])
    assert compare.relative_gap(float(loss.detach()), float(rloss.detach())) < 1e-3
    assert compare.leaf_gap({"s": float(g[0]), "b": float(g[1])}, {"s": float(rg[0]), "b": float(rg[1])}) < 1e-2


def test_winners_take_confidence_then_nearness_then_the_lowest_slot():
    from slam_bench.reference.pointfusion import _winners

    pix = torch.tensor([0, 0, 0, 1, 1, 2, 2])
    conf = torch.tensor([1.0, 2.0, 2.0, 1.0, 1.0, 3.0, 3.0])
    ray = torch.tensor([0.0, 0.5, 0.4, 0.2, 0.2, 0.1, 0.1])
    slot = torch.tensor([5, 6, 7, 9, 8, 4, 3])
    assert _winners(pix, conf, ray, slot, 4).tolist() == [7, 8, 3, -1]


def test_the_exponential_map_rotates_and_moves():
    from slam_bench.reference.pointfusion import _exp

    th = 0.3
    T = _exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, th]))
    R = torch.tensor([[math.cos(th), -math.sin(th), 0.0], [math.sin(th), math.cos(th), 0.0], [0.0, 0.0, 1.0]])
    assert torch.allclose(T[:3, :3], R, atol=1e-6)
    assert torch.allclose(T[:3, 3], torch.tensor([math.sin(th), 1 - math.cos(th), 0.0]) * 0.1 / th, atol=1e-6)
    assert torch.equal(_exp(torch.zeros(6)), torch.eye(4))


def test_the_nearest_neighbour_is_exact_and_the_control_is_not():
    from slam_bench.reference.pointfusion import _nearest

    tgt = torch.tensor([[1.0, 1.0, 1.0], [1.0 + 2**-20, 1.0, 1.0]])
    src = torch.tensor([[1.0 + 2**-19, 1.0, 1.0]])
    assert _nearest(src, tgt).tolist() == [1]
    with ref.precision.tf32_products():
        assert _nearest(src, tgt).tolist() == [0]  # the TF32 form cannot tell the two apart


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9 - 2**-11])
    y = ref.precision.tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]  # a unit of the last place at 3 is 2**-9
