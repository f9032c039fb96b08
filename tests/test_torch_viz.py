"""The port's viz exports against the JAX package's: the PLY file of a map
is byte for byte the JAX writer's, and the plotly and open3d exports raise
the JAX message where those packages are missing."""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu import viz as JV
from gradslam_tpu.structures import Pointclouds as JPointclouds
from gradslam_tpu.structures import RGBDImages as JRGBDImages
from gradslam_tpu_torch import viz as TV
from gradslam_tpu_torch.structures import Pointclouds, RGBDImages

torch.set_num_threads(2)


def _clouds(rng, colors_scale=1.0):
    pts = [rng.randn(n, 3).astype(np.float32) for n in (17, 9)]
    nrm = [rng.randn(len(p), 3).astype(np.float32) for p in pts]
    col = [(rng.rand(len(p), 3) * colors_scale).astype(np.float32) for p in pts]
    return pts, nrm, col


@pytest.mark.parametrize("colors_scale", [1.0, 255.0])
@pytest.mark.parametrize("parts", ["points", "points normals", "points normals colors", "points colors"])
def test_ply_bytes_equal_jax(tmp_path, parts, colors_scale):
    pts, nrm, col = _clouds(np.random.RandomState(0), colors_scale)
    kw = dict(normals="normals" in parts, colors="colors" in parts)
    jpc = JPointclouds([jnp.asarray(p) for p in pts], [jnp.asarray(n) for n in nrm] if kw["normals"] else None,
                       [jnp.asarray(c) for c in col] if kw["colors"] else None)
    tpc = Pointclouds([torch.from_numpy(p) for p in pts],
                      [torch.from_numpy(n) for n in nrm] if kw["normals"] else None,
                      [torch.from_numpy(c) for c in col] if kw["colors"] else None)
    for index in (0, 1):
        JV.pointclouds_to_ply(jpc, str(tmp_path / "j.ply"), index)
        TV.pointclouds_to_ply(tpc, str(tmp_path / "t.ply"), index)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_write_ply_of_a_map_equals_jax(tmp_path):
    """A fused map's arena, through ``map_to_pointclouds``, as both writers
    see it; an empty cloud too."""
    from gradslam_tpu_torch.structures import init_map, map_to_pointclouds
    from gradslam_tpu_torch.structures.maparena import append_to_map

    rng = np.random.RandomState(1)
    m = init_map(1, 50, device="cpu")
    p = torch.from_numpy(rng.randn(1, 30, 3).astype(np.float32))
    m = append_to_map(m, p, p, p.abs() / 4, torch.ones(1, 30, 1), torch.from_numpy(rng.rand(1, 30) > 0.3))
    pc = map_to_pointclouds(m)
    TV.write_ply(str(tmp_path / "t.ply"), pc.points_list[0], pc.normals_list[0], pc.colors_list[0])
    JV.write_ply(str(tmp_path / "j.ply"), pc.points_list[0].numpy(), pc.normals_list[0].numpy(),
                 pc.colors_list[0].numpy())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    TV.write_ply(str(tmp_path / "t0.ply"), torch.zeros(0, 3))
    JV.write_ply(str(tmp_path / "j0.ply"), np.zeros((0, 3)))
    assert (tmp_path / "t0.ply").read_bytes() == (tmp_path / "j0.ply").read_bytes()
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        TV.write_ply(str(tmp_path / "bad.ply"), torch.zeros(4, 2))


def _missing(name):
    return importlib.util.find_spec(name) is None


def _jax_message(fn, *args):
    with pytest.raises(ImportError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.skipif(not (_missing("plotly") and _missing("open3d")), reason="plotly or open3d is installed")
def test_exports_raise_the_jax_message_without_plotly_and_open3d():
    rng = np.random.RandomState(2)
    pts, nrm, col = _clouds(rng)
    tpc = Pointclouds([torch.from_numpy(p) for p in pts])
    jpc = JPointclouds([jnp.asarray(p) for p in pts])
    c = rng.rand(1, 2, 6, 8, 3).astype(np.float32)
    d = rng.rand(1, 2, 6, 8, 1).astype(np.float32)
    K = np.eye(4, dtype=np.float32)[None, None]
    trgbd = RGBDImages(c, d, K, device="cpu")
    jrgbd = JRGBDImages(jnp.asarray(c), jnp.asarray(d), jnp.asarray(K))
    pairs = [
        (tpc.open3d, jpc.open3d),
        (tpc.plotly, jpc.plotly),
        (trgbd.plotly, jrgbd.plotly),
        (lambda: TV.numpy_to_plotly_image(c[0, 0]), lambda: JV.numpy_to_plotly_image(c[0, 0])),
    ]
    for port, jax_fn in pairs:
        want = _jax_message(jax_fn)
        with pytest.raises(ImportError) as e:
            port()
        assert str(e.value) == want


def test_img_to_b64str_equals_jax():
    pytest.importorskip("cv2")
    img = np.random.RandomState(3).rand(8, 10, 3).astype(np.float32)
    assert TV.img_to_b64str(torch.from_numpy(img)) == JV.img_to_b64str(img)
