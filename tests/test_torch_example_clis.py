"""The port's TUM example CLIs (``examples_torch/``) run end to end as
subprocesses with ``--device cpu``, on tests/integration/test_example_clis.py's
rendered 48x64 TUM tree with that file's argv: pointfusion, icpslam,
evaluate_ate, and e2e_pipeline on the same tree (``--basedir``).

Each is held against its JAX twin in ``examples/`` at the same argv: every
printed ATE and RPE translation within 2e-4 m, RPE rotation within 0.02 deg
and map points within 0.5% (tests/test_torch_slam.py's tolerances: poses
within 2e-4, which moves a rotation by at most 0.02 deg), plus one unit of
the last printed digit where a line rounds its number. ``imagefile.imwrite``,
which e2e_pipeline writes its own tree with, round-trips 8- and 16-bit PNGs
through ``imread`` on every route this machine has.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gradslam_tpu_torch.datasets import imagefile
from tests.integration.test_example_clis import H, W
from tests.integration.test_example_clis import _run as run_jax
from tests.integration.test_example_clis import tum_tree  # noqa: F401 (fixture)

REPO = Path(__file__).parents[1]
ATE_TOL_M = 2e-4
POINTS_RTOL = 0.005
RPE_DEG_TOL = 0.02


def port_env():
    """The environment of a port CLI's process: the repo importable, and one
    intra-op thread, as the parallel test workers share the machine's
    cores."""
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def run_port(args, timeout=300):
    """``examples_torch/<args>`` with ``--device cpu``; its standard output."""
    env = port_env()
    out = subprocess.run([sys.executable, *args, "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=timeout)
    assert out.returncode == 0, f"{args}:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def numbers(line):
    """The numbers of a printed numpy array, e.g. ``ATE-RMSE ...: [0.0003 0.0002]``."""
    return np.array([float(x) for x in re.findall(r"[-+]?\d*\.?\d+(?:e[-+]?\d+)?", line.split(":", 1)[1])])


def line(out, prefix):
    found = [l for l in out.splitlines() if l.startswith(prefix)]
    assert len(found) == 1, (prefix, out)
    return found[0]


def tum_args(tree, **extra):
    """test_example_clis.py's argv for the TUM CLIs, past the script."""
    argv = ["--dataset", "tum", "--dataset_path", str(tree), "--seqlen", "4", "--height", str(H), "--width", str(W)]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return argv


def run_twins(script, args, port_args=(), jax_args=()):
    """The standard outputs of ``examples_torch/<script>`` (``--device cpu``)
    and of its JAX twin ``examples/<script>`` on the same ``args``."""
    return (run_port([f"examples_torch/{script}", *args, *port_args]),
            run_jax([f"examples/{script}", *args, *jax_args]))


def assert_close(name, a, b, tol, unit=0.0):
    """``a`` within ``tol`` of ``b`` elementwise, plus ``unit``: the last
    printed digit of a number that the line rounds (each side rounds by half
    of it)."""
    a, b = np.atleast_1d(np.asarray(a, float)), np.atleast_1d(np.asarray(b, float))
    assert a.shape == b.shape and a.size and np.all(np.abs(a - b) <= tol + unit), (name, a, b)


def assert_points_close(name, a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.shape == b.shape and a.size and np.all(np.abs(a - b) <= POINTS_RTOL * b), (name, a, b)


def assert_tum_lines_match(port, jax):
    """pointfusion.py's and icpslam.py's two result lines against the twin's."""
    assert_points_close("map points", numbers(line(port, "map points per batch:")),
                        numbers(line(jax, "map points per batch:")))
    assert_close("ATE", numbers(line(port, "ATE-RMSE vs dataset poses:")),
                 numbers(line(jax, "ATE-RMSE vs dataset poses:")), ATE_TOL_M)


def test_pointfusion_matches_its_jax_twin(tum_tree):  # noqa: F811
    extra = dict(batch_size=1, numiters=4, odometry="gradicp")
    assert_tum_lines_match(*run_twins("pointfusion.py", tum_args(tum_tree, **extra)))


def test_icpslam(tum_tree):  # noqa: F811
    port, jax = run_twins("icpslam.py", tum_args(tum_tree, batch_size=1))
    assert numbers(line(port, "map points per batch:"))[0] > 0
    assert_tum_lines_match(port, jax)


EVAL = re.compile(r"ATE-RMSE ([\d.]+) m, RPE ([\d.]+) m / ([\d.]+) deg")


def test_evaluate_ate(tum_tree):  # noqa: F811
    port, jax = run_twins("evaluate_ate.py", tum_args(tum_tree, numiters=4))
    rows = []
    for out in (port, jax):
        seqs = [l for l in out.splitlines() if l.startswith("seq ")]
        assert len(seqs) == 2, out  # 8 frames in windows of 4
        rows.append([EVAL.search(l).groups() for l in [*seqs, line(out, "mean over 2 windows:")]])
    (p, j) = (np.array(r, float) for r in rows)
    assert np.all(p[:, 0] > 0), port
    assert_close("ATE", p[:, 0], j[:, 0], ATE_TOL_M, 1e-4)  # printed in m to 4 decimals
    assert_close("RPE translation", p[:, 1], j[:, 1], ATE_TOL_M, 1e-4)
    assert_close("RPE rotation", p[:, 2], j[:, 2], RPE_DEG_TOL, 1e-3)  # in deg to 3 decimals


WINDOW = re.compile(r"window: ATE-RMSE \[([\d.e+-]+)\] m \(map points \[(\d+)\]\)")


def windows(out, n):
    """e2e_pipeline.py's per-window (ATE, map points), ``n`` of them."""
    found = [WINDOW.match(l) for l in out.splitlines() if l.startswith("window: ATE-RMSE")]
    assert len(found) == n and all(found), out
    return np.array([m.groups() for m in found], float)


def assert_e2e_matches(port, jax, n):
    p, j = windows(port, n), windows(jax, n)
    assert np.all(p[:, 1] > 0), port
    assert_close("window ATE", p[:, 0], j[:, 0], ATE_TOL_M)
    assert_points_close("window map points", p[:, 1], j[:, 1])
    assert line(port, "native C++ decoder:").split(": ")[1] in ("True", "False")
    assert "IO-included throughput:" in port


def test_e2e_pipeline_on_the_tree(tum_tree):  # noqa: F811
    port, jax = run_twins("e2e_pipeline.py", ["--basedir", str(tum_tree), "--seqlen", "4", "--height", str(H),
                                               "--width", str(W)], jax_args=["--cpu"])
    assert_e2e_matches(port, jax, 2)


MODULES = {"imageio": "imageio", "pillow": "PIL"}


@pytest.mark.parametrize("route", imagefile.ROUTES)
def test_imwrite_round_trips_through_imread(tmp_path, route):
    if not importlib.util.find_spec(MODULES[route]):
        pytest.skip(f"this machine has no {MODULES[route]}")
    rng = np.random.RandomState(0)
    color = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    depth = rng.randint(0, 65536, (5, 7)).astype(np.uint16)
    for name, img in (("c.png", color), ("d.png", depth)):
        imagefile.imwrite(str(tmp_path / name), img, route)
        for read in imagefile.ROUTES:
            if importlib.util.find_spec(MODULES[read]):
                back = imagefile.imread(str(tmp_path / name), read)
                assert back.dtype == img.dtype and np.array_equal(back, img), (route, read, name)
    with pytest.raises(ValueError, match="route"):
        imagefile.imwrite(str(tmp_path / "x.png"), color, "bmp")
