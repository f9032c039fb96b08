"""The port's CUDA kernels and main path on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): each
carries the ``cuda`` marker and skips without a card. The file imports no
JAX, so it also runs where only PyTorch is installed:

    GRADSLAM_TPU_TEST_REAL=1 python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernel and the plain version must agree bit for bit
(indices and distances); the main path on the card must match the same
run on the CPU to 1e-4 in the poses (float32 sums in another order).
"""

import pathlib

import numpy as np
import pytest
import torch

from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.ops import knn, knn_kernel, knn_reference

DATA = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _cloud(gen, shape, dev):
    return torch.from_numpy(gen.uniform(-2, 2, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("B,S,T", [(2, 1200, 5120), (2, 321, 777), (1, 4800, 19456)])
def test_knn_kernel_equals_plain_version(cuda_device, B, S, T):
    gen = np.random.default_rng(S)
    src, tgt = _cloud(gen, (B, S, 3), cuda_device), _cloud(gen, (B, T, 3), cuda_device)
    valid = torch.from_numpy(gen.random((B, T)) > 0.3).to(cuda_device)
    before = knn_kernel.launches
    d, i = knn(src, tgt, valid)
    assert knn_kernel.launches == before + 1
    dp, ip = knn_reference(src, tgt, valid)
    assert torch.equal(i, ip) and torch.equal(d, dp)


def test_knn_kernel_edge_cases(cuda_device):
    gen = np.random.default_rng(1)
    src, tgt = _cloud(gen, (2, 100, 3), cuda_device), _cloud(gen, (2, 300, 3), cuda_device)
    d, i = knn(src, tgt, torch.zeros((2, 300), dtype=torch.bool, device=cuda_device))
    assert torch.isinf(d).all() and (i == 0).all()
    d, i = knn(src, torch.cat([tgt, tgt], dim=1))  # ties: the lower index wins
    assert int(i.max()) < 300
    dp, ip = knn_reference(src, tgt)
    assert torch.equal(d, dp) and torch.equal(i, ip)


def test_knn_kernel_rejects_what_it_does_not_take(cuda_device):
    src = torch.rand((1, 8, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        knn(src, src)
    with pytest.raises(ValueError):
        knn_kernel(torch.rand((1, 8, 3), device=cuda_device), torch.rand((1, 8, 3), device=cuda_device))


def _clip():
    return tuple(np.load(DATA / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics"))


def test_frame_loop_never_waits_on_the_host(cuda_device):
    """No op of the frame loop synchronizes with the host: PyTorch's sync
    debug mode turns any such call into an error."""
    rgbd = RGBDImages(*_clip(), device=cuda_device)
    slam = PointFusion(device=cuda_device)
    slam(rgbd)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, poses = slam(rgbd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(poses).all()


def test_pointfusion_on_the_card_matches_the_cpu(cuda_device):
    c, d, K = _clip()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pcs, poses = PointFusion(device=dev)(RGBDImages(c, d, K, device=dev))
        assert poses.device.type == dev.type
        out[dev.type] = (poses.cpu().numpy(), pcs.num_points_per_pointcloud.cpu().numpy())
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() < 1e-4
    assert np.all(np.abs(out["cuda"][1] - out["cpu"][1]) <= 0.005 * out["cpu"][1])
