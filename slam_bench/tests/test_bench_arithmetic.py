"""The arithmetic of the yardstick on hand-made inputs: the interval union,
the idle share, host calls, the percentile, the breakdown and the gaps."""

import math

import pytest
import torch

from slam_bench import compare, trace


def test_interval_union_counts_overlaps_once():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 25.0), ("d", 21.0, 22.0)]
    assert trace.covered_us(ops) == 20.0
    assert trace.covered_us([]) == 0.0


def test_idle_share_is_over_the_profiled_wall():
    ops = [("k", 0.0, 600_000.0), ("k", 500_000.0, 700_000.0)]
    assert trace.idle_share(ops, 1.0) == pytest.approx(0.3)


def test_host_calls_kernels_and_device_time_by_name():
    host = [("cudaLaunchKernel", 0, 1), ("cudaGraphLaunch", 2, 3), ("cuLaunchKernelEx", 3, 4),
            ("cudaMemcpyAsync", 4, 5), ("aten::add", 5, 6)]
    assert trace.host_calls(host) == 3
    dev = [("void knn_cluster<4>(...)", 0.0, 2000.0), ("tensor_kernel_scan_innermost_dim", 0.0, 500.0),
           ("Memcpy DtoD", 0.0, 100.0), ("Memset (Device)", 0.0, 1.0)]
    assert trace.device_ms(dev, trace.KNN_KERNELS) == 2.0
    assert trace.scan_ms(dev) == 0.5
    assert trace.kernel_count(dev) == 2


def test_p95_is_the_nearest_rank():
    assert trace.p95(range(1, 101)) == 95
    assert trace.p95([3.0]) == 3.0
    assert trace.p95(list(range(20, 0, -1))) == 19


def test_breakdown_sums_device_time_and_names_gaps_by_the_host():
    dev = [("k1", 0.0, 10.0), ("k2", 30.0, 40.0), ("k1", 40.0, 45.0), ("k2", 100.0, 101.0)]
    host = [("outer", 0.0, 200.0), ("cudaStreamSynchronize", 12.0, 29.0)]
    b = trace.breakdown(dev, host)
    assert b["device_ops"] == [["k1", pytest.approx(15e-6)], ["k2", pytest.approx(11e-6)]]
    assert dict(b["idle_gaps"]) == pytest.approx({"cudaStreamSynchronize": 20e-6, "outer": 55e-6})


def test_pose_gaps_read_translation_and_rotation():
    a = torch.eye(4).repeat(1, 3, 1, 1)
    b = a.clone()
    b[0, 2, 0, 3] = 0.003
    th = math.radians(0.5)
    b[0, 1, :2, :2] = torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    g = compare.pose_gaps(b, a)
    assert g["pose_gap_m"] == pytest.approx(0.003, rel=1e-6)
    assert g["pose_gap_deg"] == pytest.approx(0.5, rel=1e-4)
    assert compare.pose_gaps(a, a) == {"pose_gap_m": 0.0, "pose_gap_deg": 0.0}


def test_map_gaps_pair_each_row_with_the_nearest_whatever_the_order():
    ref = torch.zeros(5, 10)
    ref[:, 0] = torch.arange(5.0)  # points 1 m apart along x
    ref[:, 3:6] = torch.tensor([0.0, 0.0, 1.0])
    ref[:, 6:9] = 100.0
    ref[:, 9] = 2.0
    out = torch.zeros(1, 8, 12)
    out[0, :5, :10] = ref.flip(0)  # the same rows in another order
    out[0, 6, 0] = 99.0  # past the count: not read
    g = compare.map_gaps(compare.arena_rows(out, torch.tensor([5])), [ref], seed=1)
    assert g == {"num_points_gap": 0.0, "points_gap_m": 0.0, "normals_gap": 0.0, "colors_gap": 0.0, "conf_gap": 0.0}
    out[0, :5, 0] += 0.01
    out[0, :5, 7] += 6.0
    out[0, :5, 9] -= 0.5
    g = compare.map_gaps(compare.arena_rows(out, torch.tensor([4])), [ref], seed=1)
    assert g["num_points_gap"] == pytest.approx(0.2)
    assert g["colors_gap"] == pytest.approx(6.0) and g["conf_gap"] == pytest.approx(0.25)
    assert 0.01 - 1e-6 < g["points_gap_m"] < 0.5 and g["normals_gap"] == 0.0


def test_leaf_gap_is_signed_and_against_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 1e-9, "c": -3.0}
    assert compare.leaf_gap({"a": 1.1, "b": 2e-9, "c": -3.0}, ref) == pytest.approx(0.1)
    assert compare.leaf_gap({"a": 1.0, "b": 0.5, "c": -3.0}, ref) == pytest.approx(0.5)
    assert compare.leaf_gap({"a": -1.0, "b": 1e-9, "c": -3.0}, ref) == pytest.approx(2.0)  # the sign flipped
    assert compare.leaf_gap({"a": 9.0, "b": 0.0, "c": -3.0}, ref, skip={"a"}) == pytest.approx(1e-9 / 1.5)


def test_verdict_fails_a_number_over_its_limit_not_finite_or_without_one():
    assert compare.verdict({"x": 1.0}, {"x": 1.0})[0]
    assert not compare.verdict({"x": 1.5}, {"x": 1.0})[0]
    assert not compare.verdict({"x": math.inf}, {"x": 1.0})[0]
    assert not compare.verdict({"x": math.nan}, {"x": 1.0})[0]
    assert not compare.verdict({"x": 0.0}, {})[0]
    assert not compare.verdict({}, {"x": 1.0})[0]
    assert compare.verdict({"x": 0.5, "y": 9.0}, {"x": 1.0}) == (True, [("x", 0.5, 1.0)])
