"""The port's tutorials (``examples_torch/tutorials/``) run end to end as
subprocesses with ``--device cpu`` at their defaults, each held against its
JAX twin in ``examples/tutorials/``: the PointFusion tutorial's map points
and ATE at tests/test_torch_example_clis.py's tolerances, the structures
tutorial's lines equal (a shape printed as ``torch.Size`` read as the
tuple JAX prints) and its transformed point within 1e-6.
"""

import re

from tests.test_torch_example_clis import ATE_TOL_M, assert_close, assert_points_close, line, numbers, run_twins


def test_pointfusion_tutorial():
    port, jax = run_twins("tutorials/pointfusion_tutorial.py", [])
    assert line(port, "vertex map:").endswith("torch.Size([2, 3, 120, 160, 3])")
    points = numbers(line(port, "map points per batch:"))
    assert points.min() > 0
    assert_points_close("map points", points, numbers(line(jax, "map points per batch:")))
    ate = numbers(line(port, "ATE-RMSE:"))
    assert ate.max() < 2e-3  # the goldens' bound
    assert_close("ATE", ate, numbers(line(jax, "ATE-RMSE:")), ATE_TOL_M)


def _as_tuple(text):
    """A printed ``torch.Size([...])`` as the tuple the JAX twin prints."""
    return re.sub(r"torch\.Size\(\[([^\]]*)\]\)", r"(\1)", text)


def test_structures_tutorial():
    port, jax = run_twins("tutorials/structures_tutorial.py", [])
    assert line(port, "shape (B, L, H, W):").endswith("(2, 3, 120, 160)")
    assert line(port, "one frame:").endswith("(1, 1, 120, 160)")
    assert "num_points=[100, 60]" in line(port, "pointclouds:")
    assert numbers(line(port, "frame cloud sizes:")).min() > 0
    p, j = _as_tuple(port).splitlines(), jax.splitlines()
    moved = "transformed first point:"
    assert [l for l in p if not l.startswith(moved)] == [l for l in j if not l.startswith(moved)], (port, jax)
    assert_close(moved, numbers(line(port, moved)), numbers(line(jax, moved)), 1e-6)
