"""The port's loop-closure and training examples (``examples_torch/``) run
end to end as subprocesses with ``--device cpu``: loop_closure at its
defaults, and the two training scripts for two steps. Each draws its world
and drift from the same seeded numpy ``RandomState`` as its JAX twin in
``examples/``, and is held against that twin at the same argv:

- loop_closure: the accepted edges equal; the final-frame and mean errors
  within 2e-4 m (tests/test_torch_slam.py's pose tolerance).
- train_depth_calib: each step's loss within 1e-3 relative
  (tests/test_torch_calib.py's tolerance); the scale and bias lines equal,
  as each step is the normalized one.
- train_loopclosure_ate: each step's post-closure ATE within 2e-4 m, its
  scale within 1e-4 and its loop edges equal.

Each printed number also gets one unit of its last printed digit, as the
line rounds it.
"""

import ast
import re

import numpy as np
import pytest

from tests.test_torch_example_clis import ATE_TOL_M, assert_close, line, run_twins


def _errors(out, prefix):
    """(before, after) of a loop_closure.py error line."""
    return np.array(re.findall(r"([\d.]+)", line(out, prefix)), float)


def test_loop_closure():
    port, jax = run_twins("loop_closure.py", [])
    edges = ast.literal_eval(line(port, "loop edges accepted:").split(": ", 1)[1])
    assert edges and all(j - i >= 5 for i, j in edges)
    assert edges == ast.literal_eval(line(jax, "loop edges accepted:").split(": ", 1)[1])
    before, after = _errors(port, "final-frame error:")
    assert after < 0.5 * before
    before, after = _errors(port, "mean error:")
    assert after < before
    for prefix in ("final-frame error:", "mean error:"):
        assert_close(prefix, _errors(port, prefix), _errors(jax, prefix), ATE_TOL_M, 1e-4)


CALIB = re.compile(r"step +(\d+): loss ([\d.e+-]+) scale ([\d.]+) bias ([+-][\d.]+)")


def _steps(out, pattern, n):
    found = [pattern.match(l) for l in out.splitlines() if l.startswith("step ")]
    assert len(found) == n and all(found), out
    return [m.groups() for m in found]


def test_train_depth_calib_two_steps():
    port, jax = run_twins("train_depth_calib.py", ["--steps", "2"])
    steps = _steps(port, CALIB, 2)  # steps 0 and the last
    scales = [float(s[2]) for s in steps]
    # two normalized steps towards the true 1.1: 0.05, then 0.05/2 (the
    # halving period is max(steps/3, 1) = 1 step)
    assert scales[0] == pytest.approx(1.05, abs=1e-4) and 1.05 < scales[1] < 1.1
    assert all(s[3] == "+0.00000" for s in steps)
    assert "recovered scale" in line(port, "recovered scale")
    twin = _steps(jax, CALIB, 2)
    assert [(s[0], s[2], s[3]) for s in steps] == [(s[0], s[2], s[3]) for s in twin], (port, jax)
    for p, j in zip(steps, twin):
        loss, ref = float(p[1]), float(j[1])
        unit = 10.0 ** (np.floor(np.log10(ref)) - 3)  # 4 significant digits
        assert_close("loss", loss, ref, 1e-3 * ref, unit)
    assert line(port, "recovered scale") == line(jax, "recovered scale")


CLOSURE = re.compile(r"step +(\d+): post-closure ATE ([\d.]+) m, scale ([\d.]+) \(true [\d.]+\), loop edges (\d+)")


def test_train_loopclosure_ate_two_steps():
    port, jax = run_twins("train_loopclosure_ate.py", ["--steps", "2"], jax_args=["--cpu"])
    steps = np.array(_steps(port, CLOSURE, 2), float)
    ates, scales, edges = steps[:, 1], steps[:, 2], steps[:, 3]
    assert ates[1] < ates[0] and 1.0 < scales[0] < scales[1] < 1.15
    assert np.all(edges > 0)
    assert line(port, "recovered range scale").endswith("%")
    twin = np.array(_steps(jax, CLOSURE, 2), float)
    assert np.array_equal(edges, twin[:, 3]) and np.array_equal(steps[:, 0], twin[:, 0]), (port, jax)
    assert_close("post-closure ATE", ates, twin[:, 1], ATE_TOL_M, 1e-5)
    assert_close("scale", scales, twin[:, 2], 1e-4, 1e-4)
