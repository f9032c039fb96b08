"""The port's ScanNet CLIs (``examples_torch/``) run end to end as
subprocesses with ``--device cpu`` on tests/datasets/test_loaders.py's
``scannet_dir`` tree at the files' own 48x64 (with and without the semantic
PLY), and e2e_pipeline on the tree it renders itself. Each is held against
its JAX twin in ``examples/`` at the same argv, at
tests/test_torch_example_clis.py's tolerances.
"""

import re

import pytest

from tests.datasets.test_loaders import H_RAW, W_RAW, scannet_dir  # noqa: F401 (fixture)
from tests.test_torch_example_clis import (
    ATE_TOL_M,
    assert_close,
    assert_e2e_matches,
    assert_points_close,
    line,
    numbers,
    run_twins,
)


def scannet_args(root, *extra):
    return ["--scannet_path", str(root / "scans"), "--scannet_meta_path", str(root / "meta"), "--height", str(H_RAW),
            "--width", str(W_RAW), *extra]


def assert_scannet_lines_match(port, jax):
    points = numbers(line(port, "map points:"))
    assert points.shape == (1,) and points[0] > 0
    assert_points_close("map points", points, numbers(line(jax, "map points:")))
    assert_close("ATE", numbers(line(port, "ATE-RMSE vs dataset poses:")),
                 numbers(line(jax, "ATE-RMSE vs dataset poses:")), ATE_TOL_M)
    return points[0]


def _ply_vertices(path):
    blob = path.read_bytes()
    head = blob[: blob.index(b"end_header\n")].decode()
    return int(re.search(r"element vertex (\d+)", head).group(1))


@pytest.mark.parametrize("semantic", [False, True], ids=["plain", "semantic_ply"])
def test_pointfusion_scannet(scannet_dir, tmp_path, semantic):  # noqa: F811
    plys = {k: tmp_path / f"labels_{k}.ply" for k in ("port", "jax")}
    flags = {k: ["--semantic_ply", str(ply)] if semantic else [] for k, ply in plys.items()}
    port, jax = run_twins("pointfusion_scannet.py", scannet_args(scannet_dir), flags["port"], flags["jax"])
    points = assert_scannet_lines_match(port, jax)
    if semantic:
        ns = [int(re.search(r"\((\d+) points\)", line(out, "semantic PLY written to")).group(1)) for out in (port, jax)]
        assert ns[0] == points == _ply_vertices(plys["port"]), (ns, points)
        assert_points_close("PLY vertices", ns[0], _ply_vertices(plys["jax"]))
    else:
        assert not any(p.exists() for p in plys.values())


def test_icpslam_scannet(scannet_dir):  # noqa: F811
    assert_scannet_lines_match(*run_twins("icpslam_scannet.py", scannet_args(scannet_dir)))


def test_e2e_pipeline_renders_its_own_tree():
    port, jax = run_twins("e2e_pipeline.py", [], jax_args=["--cpu"])
    assert "rendered synthetic TUM tree at" in port
    assert_e2e_matches(port, jax, 2)  # 12 rendered frames in windows of 6
