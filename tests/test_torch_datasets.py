"""The port's dataset loaders and DataLoader against the JAX package's (mirrors tests/datasets/).

TUM, ICL and ScanNet trees synthesized in tmp (the fixtures of
tests/datasets/test_loaders.py) are read by both packages; every returned
array is equal, dtype included, on each decode route: the native C++ loader
against the JAX package's, and each Python route of the port (imageio,
Pillow) against the JAX package's imageio path.
"""

import ctypes
import fcntl
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from gradslam_tpu import datasets as J
from gradslam_tpu.datasets import dataloader as j_dataloader
from gradslam_tpu_torch import datasets as T
from gradslam_tpu_torch.datasets import imagefile, native_loader
from tests.datasets.test_loaders import icl_dir, scannet_dir, tum_dir  # noqa: F401 (fixtures)


def _build_native_loader():
    """Builds the JAX package's ``native/libgsloader.so`` before any test runs.

    Its loader runs ``make`` at first use, which writes the library in place;
    under pytest-xdist several workers race for that build, and one that
    loads a half-written library caches "unavailable" and decodes in Python
    (the native cases here then fail). Every worker imports this module
    while collecting, before the first test, so the build happens here:
    the Makefile's command and flags into a temporary file in ``native/``,
    renamed over the library under a lock, skipped when a complete library
    loads. The library is a build product that ``.gitignore`` lists.
    """
    native = pathlib.Path(__file__).resolve().parents[1] / "native"
    lib = native / "libgsloader.so"

    def complete():
        try:
            return bool(ctypes.CDLL(str(lib)).gs_load_color_batch)
        except (OSError, AttributeError):
            return False

    cxxflags = os.environ.get("CXXFLAGS", "-O3 -march=native -std=c++17 -fPIC -Wall").split()
    tmp = None
    try:
        with open(native / "Makefile", "rb") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if lib.exists() and complete():
                return
            fd, tmp = tempfile.mkstemp(dir=native, prefix=".libgsloader.", suffix=".so")
            os.close(fd)
            subprocess.run(
                [os.environ.get("CXX", "g++"), *cxxflags, "-shared", "loader.cpp", "-o", tmp,
                 "-lpng", "-ljpeg", "-lpthread"],
                cwd=native, check=True, capture_output=True, timeout=240,
            )
            os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        pass  # no toolchain or no write access: the JAX loader's own build decides, as before
    finally:
        if tmp is not None:
            pathlib.Path(tmp).unlink(missing_ok=True)


_build_native_loader()

PY_ROUTES = ["imageio", "pillow"]


@pytest.fixture
def route(request, monkeypatch):
    """Forces the port's Python decode route (``use_native=False``), or
    'native' (the C++ loader, skipped where it does not build)."""
    name = request.param
    if name == "native":
        if not native_loader.native_available():
            pytest.skip("native loader toolchain unavailable")
    else:
        monkeypatch.setattr(imagefile, "python_route", lambda: name)
    return name


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
        else:
            assert g == w


TUM_CASES = {
    "resize": dict(seqlen=4, height=24, width=32),
    "full size": dict(seqlen=2, height=48, width=64),
    "dilation stride": dict(seqlen=3, dilation=1, stride=2, height=48, width=64),
    "start end channels_first": dict(seqlen=2, start=4, end=8, height=48, width=64, channels_first=True),
    "normalize, no poses": dict(seqlen=3, height=48, width=64, normalize_color=True, return_pose=False,
                                return_transform=False, return_timestamps=False),
}


@pytest.mark.parametrize("route", ["native", *PY_ROUTES], indirect=True)
@pytest.mark.parametrize("case", list(TUM_CASES))
def test_tum_equals_jax(tum_dir, route, case):  # noqa: F811
    kw = dict(TUM_CASES[case], use_native=route == "native")
    jd, td = J.TUM(str(tum_dir), **kw), T.TUM(str(tum_dir), **kw)
    assert len(td) == len(jd) and td.decode_route == route
    for i in range(len(jd)):
        _assert_same(td[i], jd[i])


@pytest.mark.parametrize("route", ["native", *PY_ROUTES], indirect=True)
def test_icl_equals_jax(icl_dir, route):  # noqa: F811
    for kw in (dict(seqlen=4, height=24, width=32), dict(seqlen=3, height=48, width=64, return_timestamps=True)):
        kw["use_native"] = route == "native"
        jd, td = J.ICL(str(icl_dir), **kw), T.ICL(str(icl_dir), **kw)
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _assert_same(td[i], jd[i])


@pytest.mark.parametrize("route", ["imageio", "pillow"], indirect=True)
@pytest.mark.parametrize("kw", [dict(height=24, width=32), dict(height=48, width=64, seg_classes="nyu40"),
                                dict(start=2, end=5, height=48, width=64, channels_first=True)])
def test_scannet_equals_jax(scannet_dir, route, kw):  # noqa: F811
    args = (str(scannet_dir / "scans"), str(scannet_dir / "meta"), ("scene0000_00",))
    jd, td = J.Scannet(*args, **kw), T.Scannet(*args, **kw)
    assert len(td) == len(jd) and td.decode_route == route
    _assert_same(td[0], jd[0])


def test_imread_needs_imageio_or_pillow(tum_dir, monkeypatch):  # noqa: F811
    png = next((tum_dir / "rgbd_dataset_freiburg1_test" / "rgb").glob("*.png"))
    with pytest.raises(ValueError, match="route"):
        imagefile.imread(png, "bmp")
    real_find_spec = imagefile.importlib.util.find_spec
    monkeypatch.setattr(imagefile.importlib.util, "find_spec",
                        lambda name, *a: None if name in ("imageio", "PIL") else real_find_spec(name, *a))
    ds = T.TUM(str(tum_dir), seqlen=2, height=48, width=64, use_native=False)
    with pytest.raises(ImportError, match="imageio or Pillow"):
        ds[0]


def test_resize_without_opencv_raises(tum_dir, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    ds = T.TUM(str(tum_dir), seqlen=2, height=24, width=32, use_native=False)
    with pytest.raises(ImportError, match="OpenCV"):
        ds[0]
    full = T.TUM(str(tum_dir), seqlen=2, height=48, width=64, use_native=False)
    assert full[0][0].shape == (2, 48, 64, 3)  # no resize, no cv2


def test_loader_validation_and_helpers(tum_dir):  # noqa: F811
    with pytest.raises(ValueError):
        T.TUM(str(tum_dir), seqlen=2, start=5, end=5)
    with pytest.raises(ValueError):
        T.TUM(str(tum_dir / "missing"))
    seq = tum_dir / "rgbd_dataset_freiburg1_test"
    assert T.tumutils.read_file_list(str(seq / "rgb.txt")) == J.tumutils.read_file_list(str(seq / "rgb.txt"))
    jt = J.tumutils.read_trajectory(str(seq / "groundtruth.txt"))
    tt = T.tumutils.read_trajectory(str(seq / "groundtruth.txt"))
    assert list(jt) == list(tt) and all(np.array_equal(jt[k], tt[k]) for k in jt)
    rng = np.random.RandomState(0)
    pq = rng.randn(5, 7).astype(np.float32)
    assert np.array_equal(T.datautils.pointquaternion_to_homogeneous(pq),
                          J.datautils.pointquaternion_to_homogeneous(pq))
    lab = rng.randint(0, 41, (6, 7))
    assert np.array_equal(T.nyu40_to_scannet20(lab), J.nyu40_to_scannet20(lab))
    assert T.get_color_encoding("nyu40") == J.get_color_encoding("nyu40")


def test_synth_renders_the_jax_frames():
    from gradslam_tpu.datasets import synth as j_synth
    from gradslam_tpu_torch.datasets import synth as t_synth

    a = j_synth.render_loop_sequence(n_frames=3, H=12, W=16, depth_noise=0.003, seed=1)
    b = t_synth.render_loop_sequence(n_frames=3, H=12, W=16, depth_noise=0.003, seed=1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------


class ArrayDataset:
    def __init__(self, n=10, shape=(4, 6, 3)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full(self.shape, float(i), dtype=np.float32)
        return x, np.int64(i), f"sample_{i}"


@pytest.mark.parametrize("kw", [dict(), dict(drop_last=False, batch_size=3), dict(shuffle=True, seed=5),
                                dict(num_workers=0), dict(num_workers=3, prefetch=1, batch_size=4)])
def test_dataloader_order_and_collate_equal_jax(kw):
    kw = {"batch_size": 2, **kw}
    jl, tl = j_dataloader.DataLoader(ArrayDataset(11), **kw), T.DataLoader(ArrayDataset(11), **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):  # the shuffle changes per epoch, the same way
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            _assert_same(a, b)


def test_default_collate_and_errors():
    out = T.default_collate([(np.zeros(2), 1, "a"), (np.ones(2), 2, "b")])
    assert out[0].shape == (2, 2) and list(out[1]) == [1, 2] and out[2] == ["a", "b"]
    with pytest.raises(ValueError):
        T.default_collate([])
    with pytest.raises(ValueError):
        T.DataLoader(ArrayDataset(4), batch_size=0)

    class Broken(ArrayDataset):
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("decode failed")
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="decode failed"):
        list(T.DataLoader(Broken(8), batch_size=2, num_workers=2))


def test_to_device_cpu_gives_tensors():
    batch = next(iter(T.DataLoader(ArrayDataset(4), batch_size=2, num_workers=0, to_device="cpu")))
    assert isinstance(batch[0], torch.Tensor) and batch[0].device.type == "cpu"
    assert batch[0].dtype == torch.float32 and batch[1].dtype == torch.int64
    assert torch.equal(batch[0][1], torch.full((4, 6, 3), 1.0))
    assert batch[2] == ["sample_0", "sample_1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.DataLoader(ArrayDataset(4), to_device=True)


def test_tum_through_the_dataloader(tum_dir):  # noqa: F811
    ds = T.TUM(str(tum_dir), seqlen=3, height=24, width=32)
    loader = T.DataLoader(ds, batch_size=2, num_workers=2, to_device="cpu")
    colors, depths, K, poses, transforms, names, stamps = next(iter(loader))
    assert colors.shape == (2, 3, 24, 32, 3) and depths.shape == (2, 3, 24, 32, 1)
    assert K.shape == (2, 1, 4, 4) and poses.shape == (2, 3, 4, 4)
    assert names == ["rgbd_dataset_freiburg1_test"] * 2
    assert torch.equal(colors[1], torch.from_numpy(ds[1][0]))
