"""Files on disk to ATE through the port (mirrors
tests/integration/test_real_format_e2e.py, loop closure aside).

The rendered 48x64 sequence of that module (a textured surface, a known
translating camera, exact ray-cast depth) is written as real TUM and ScanNet
trees, then run through the production chain of the port:

    TUM / Scannet -> DataLoader(num_workers, prefetch, to_device) ->
    slam_sequence_managed -> ate_rmse

ATE must stay below 5e-3 m, the JAX test's bound. The decode/compute
overlap is checked on recorded timestamps: while the chain computes on
batch k, the loader's workers are already decoding batch k+1.
"""

import threading
import time

import numpy as np
import torch

from gradslam_tpu_torch.datasets import TUM, DataLoader, Scannet
from gradslam_tpu_torch.metrics import ate_rmse
from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence_managed
from tests.integration.test_real_format_e2e import (  # noqa: F401 (fixtures)
    H,
    N_FRAMES,
    W,
    rendered,
    scannet_tree,
    tum_tree,
)

torch.set_num_threads(2)

OPTS = SLAMOptions(odom="gradicp", numiters=12, dsratio=2, fusion=True)


def _managed(colors, depths, K):
    """The managed run at an arena of L frames, compacting at the default
    watermark; returns its poses."""
    L = colors.shape[1]
    _, poses = slam_sequence_managed(colors, depths, K, None, OPTS, L * H * W, segment_len=4)
    return poses


def test_tum_files_to_ate(tum_tree):  # noqa: F811
    ds = TUM(str(tum_tree), seqlen=6, height=H, width=W)
    assert len(ds) == 2
    loader = DataLoader(ds, batch_size=2, num_workers=2, prefetch=2, to_device="cpu")
    batches = list(loader)
    assert len(batches) == 1
    colors, depths, K, gt, transforms, names, stamps = batches[0]
    assert colors.shape == (2, 6, H, W, 3) and gt.shape == (2, 6, 4, 4)
    ate = ate_rmse(_managed(colors, depths, K), gt)
    assert ate.shape == (2,)
    assert float(ate.max()) < 5e-3, ate


def test_depth_roundtrip_exact(tum_tree, rendered):  # noqa: F811
    _, depths, _ = rendered
    got = TUM(str(tum_tree), seqlen=N_FRAMES, height=H, width=W)[0][1][..., 0]
    np.testing.assert_allclose(got, depths, atol=1.01 / 5000.0)


def test_scannet_files_to_ate(scannet_tree):  # noqa: F811
    """JPEG color, 16-bit depth, per-frame pose, label and intrinsics files."""
    ds = Scannet(str(scannet_tree / "scans"), str(scannet_tree / "meta"), scenes=("scene0042_00",),
                 height=H, width=W)
    colors, depths, K, gt, transforms, names, labels = next(iter(DataLoader(ds, batch_size=1, num_workers=2,
                                                                            to_device="cpu")))
    assert labels.shape == (1, N_FRAMES, H, W, 1) and labels.dtype == torch.int64
    ate = ate_rmse(_managed(colors, depths, K), gt)
    assert float(ate.max()) < 5e-3, ate


class _Timed:
    """A dataset that records when each of its items was decoded."""

    def __init__(self, ds):
        self.ds, self.spans, self.lock = ds, {}, threading.Lock()

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        out = self.ds[i]
        with self.lock:
            self.spans[i] = (t0, time.perf_counter())
        return out


def test_prefetch_decodes_the_next_batch_during_compute(tum_tree):  # noqa: F811
    """Overlapping windows, one per batch: the decode of batch k+1 starts
    before the compute on batch k ends, for every k."""
    ds = _Timed(TUM(str(tum_tree), seqlen=4, stride=2, height=H, width=W))
    n = len(ds)
    assert n >= 4
    loader = DataLoader(ds, batch_size=1, num_workers=2, prefetch=2, to_device="cpu")
    compute = []
    for colors, depths, K, *_ in loader:
        t0 = time.perf_counter()
        _managed(colors, depths, K)
        compute.append((t0, time.perf_counter()))
    assert len(compute) == n
    for k in range(n - 1):
        decode_start = ds.spans[k + 1][0]
        assert decode_start < compute[k][1], (k, decode_start, compute[k])
        assert ds.spans[k + 1][1] <= compute[k + 1][0]  # and it was ready before its own compute
