"""The port's SLAM driver against the JAX package, and its public API.

``slam_sequence`` (PointFusion, gradicp, L=3 of the msrd clip) runs in both
packages from the same numpy inputs. Tolerances: poses within 2e-4 and
``num_points`` within 0.5%; the measured gap is ~1e-7 in the poses and
none in the counts (float32 rounding of 3- and 4-term sums differs
between XLA and PyTorch and never moved an association here).
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.slam import icpslam as JS
from gradslam_tpu_torch import PointFusion, RGBDImages, init_map
from gradslam_tpu_torch.slam import icpslam as TS
from gradslam_tpu_torch.structures.maparena import map_state_to_numpy

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).parents[1]
DATA = REPO / "tests" / "data" / "msrd_b2s3"
H, W = 120, 160


@pytest.fixture(scope="module")
def clip():
    return {n: np.load(DATA / f"{n}.npy").astype(np.float32)
            for n in ("colors", "depths", "intrinsics", "poses")}


def test_slam_sequence_gradicp_matches_jax(clip):
    L = 3
    c, d, K = clip["colors"], clip["depths"], clip["intrinsics"]
    mj, pj = JS.slam_sequence(jnp.asarray(c), jnp.asarray(d), jnp.asarray(K), None,
                              JS.SLAMOptions(odom="gradicp", fusion=True), L * H * W)
    mt, pt = TS.slam_sequence(torch.from_numpy(c), torch.from_numpy(d), torch.from_numpy(K), None,
                              TS.SLAMOptions(odom="gradicp", fusion=True), L * H * W)
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 2e-4
    nj, nt = np.asarray(mj.num_points), mt.num_points.numpy()
    assert np.all(np.abs(nt - nj) <= 0.005 * nj), (nt, nj)


def test_stateful_steps_match_jax_from_a_carried_state(clip):
    """A JAX SLAMState after frame 0 carried into the port; one gradicp
    step in each package gives the same pose and counts."""
    c, d, K = clip["colors"], clip["depths"], clip["intrinsics"]
    jopts = JS.SLAMOptions(odom="gradicp", fusion=True)
    js = jax.jit(JS.slam_init_state, static_argnames=("opts", "capacity"))(
        jnp.asarray(c[:, 0]), jnp.asarray(d[:, 0]), jnp.asarray(K), opts=jopts, capacity=2 * H * W
    )
    ts = TS.slam_state_from_numpy(
        np.asarray(js.map_state.data), np.asarray(js.map_state.num_points), np.asarray(js.pose),
        np.asarray(js.cand_slots), np.asarray(js.cand_valid), np.asarray(js.app_start),
        np.asarray(js.model_img), device="cpu",
    )
    back = TS.slam_state_to_numpy(ts)
    np.testing.assert_array_equal(back["map_data"], np.asarray(js.map_state.data))
    np.testing.assert_array_equal(back["model_img"], np.asarray(js.model_img))
    assert back["model_rows"] is None
    js = jax.jit(JS.slam_step_state, static_argnames=("opts",))(
        js, jnp.asarray(c[:, 1]), jnp.asarray(d[:, 1]), jnp.asarray(K), opts=jopts
    )
    ts = TS.slam_step_state(ts, torch.from_numpy(c[:, 1]), torch.from_numpy(d[:, 1]),
                            torch.from_numpy(K), TS.SLAMOptions(odom="gradicp", fusion=True))
    assert np.abs(ts.pose.numpy() - np.asarray(js.pose)).max() < 2e-4
    np.testing.assert_array_equal(ts.map_state.num_points.numpy(), np.asarray(js.map_state.num_points))
    np.testing.assert_array_equal(ts.app_start.numpy(), np.asarray(js.app_start))


def test_pointfusion_public_api(clip):
    rgbd = RGBDImages(clip["colors"][:, :2], clip["depths"][:, :2], clip["intrinsics"],
                      clip["poses"][:, :2], device="cpu")
    slam = PointFusion(odom="gt", device="cpu")
    pcs, poses = slam(rgbd)
    np.testing.assert_array_equal(poses.numpy(), clip["poses"][:, :2])
    n = pcs.num_points_per_pointcloud.numpy()
    valid0 = (clip["depths"][:, 0, ..., 0] > 0).sum(axis=(1, 2))
    assert np.all(n >= valid0) and np.all(n <= 2 * H * W)
    # the incremental API gives the same map
    state = slam.init_state(rgbd[:, 0], capacity=2 * H * W)
    state = slam.step_state(state, rgbd[:, 1])
    np.testing.assert_array_equal(state.map_state.num_points.numpy(), n)
    m, pose = slam.step(init_map(2, 2 * H * W, device="cpu"), rgbd[:, 0])
    data, npts = map_state_to_numpy(m)
    assert (npts == valid0).all() and np.isfinite(data).all()


def test_icpslam_aggregate_and_options(clip):
    rgbd = RGBDImages(clip["colors"][:1, :2], clip["depths"][:1, :2], clip["intrinsics"][:1],
                      device="cpu")
    pcs, poses = TS.ICPSLAM(odom="icp", numiters=3, odom_targets="recent", device="cpu")(rgbd)
    assert np.isfinite(poses.numpy()).all()
    valid = (clip["depths"][:1, :2, ..., 0] > 0).sum()
    assert pcs.num_points_per_pointcloud.tolist() == [valid]
    with pytest.raises(NotImplementedError):
        PointFusion(assoc="projective", device="cpu")
    with pytest.raises(NotImplementedError):
        PointFusion(loop_closure="pose", device="cpu")
    with pytest.raises(ValueError):
        PointFusion(odom="bogus", device="cpu")
    PointFusion(merge_window=0, device="cpu")  # accepted: a TPU layout option


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointFusion()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RGBDImages(np.zeros((1, 1, 2, 2, 3), np.float32), np.ones((1, 1, 2, 2, 1), np.float32),
                   np.eye(4, dtype=np.float32)[None, None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_map(1, 4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, gradslam_tpu_torch, gradslam_tpu_torch.slam, gradslam_tpu_torch.ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gradslam_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    files = sorted((REPO / "gradslam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "gradslam_tpu"), (f, mod)


def test_port_is_lint_clean():
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint.py"), "gradslam_tpu_torch", "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone, or on a machine with no card, the smoke script prints no
    result and exits non-zero."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
