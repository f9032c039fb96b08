"""gradslam_tpu_torch.ops against gradslam_tpu.ops.

``compact_masked`` must equal both JAX methods exactly, and its plain
version and ``append_slots``' numpy. The plain KNN must
give the JAX plain KNN's indices and distances exactly: both compute
``(dx*dx + dy*dy) + dz*dz`` with one rounding per operation and take the
first minimum. The CUDA kernel against the plain version needs the card:
those tests are in test_torch_cuda.py.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.ops import knn as jax_knn
from gradslam_tpu.ops import knn_reference as jax_knn_reference
from gradslam_tpu.ops import prepare_targets as jax_prepare_targets
from gradslam_tpu.ops.masking import compact_masked as jax_compact_masked
from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.odometry import icputils
from gradslam_tpu_torch.ops import (
    KnnTargets,
    append_slots,
    append_slots_reference,
    compact_masked,
    compact_masked_reference,
    icp_system_kernel,
    knn,
    knn_kernel,
    knn_reference,
    mask_scan_kernel,
    prepare_targets,
    winner_kernel,
)
from gradslam_tpu_torch.ops.winner import _WinnerKernel
from gradslam_tpu_torch.utils import cuda_build, profiling
from tests.mask_cases import MASK_EDGES, mask_case

torch.set_num_threads(2)


@pytest.mark.parametrize("N,out_size,density", [
    (300, 100, 0.2),   # fits
    (300, 40, 0.5),    # overflow: the lowest indices win
    (5000, 3000, 0.9),  # overflow across several JAX sort blocks
    (4099, 4099, 0.0),  # nothing selected
])
def test_compact_masked_equals_both_jax_methods(N, out_size, density):
    rng = np.random.default_rng(N + out_size)
    mask = rng.random((3, N)) < density
    idx_t, val_t = compact_masked(torch.from_numpy(mask), out_size)
    for method in ("scatter", "sort"):
        idx_j, val_j = jax_compact_masked(jnp.asarray(mask), out_size, method=method)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    assert idx_t.dtype == torch.int32
    # overflow keeps the first out_size selected positions, in order
    first = [np.flatnonzero(m)[:out_size] for m in mask]
    for b in range(3):
        np.testing.assert_array_equal(idx_t[b, : len(first[b])].numpy(), first[b])


def _numpy_compact(mask, out_size):
    idx = np.zeros((mask.shape[0], out_size), np.int32)
    valid = np.zeros((mask.shape[0], out_size), bool)
    for b, row in enumerate(mask):
        sel = np.flatnonzero(row)[:out_size]
        idx[b, : len(sel)], valid[b, : len(sel)] = sel, True
    return idx, valid


@pytest.mark.parametrize("case", list(MASK_EDGES))
def test_mask_scan_plain_versions_equal_numpy(case):
    """The plain compaction and slots, which the card tests hold the scan
    kernel to, against numpy: the first ``out_size`` selected positions,
    and ``num_points + cumsum(mask) - 1`` with the selected count."""
    B, N, out_size, share = MASK_EDGES[case]
    mask, num_points = mask_case(B, N, share, seed=N + B)
    want_idx, want_valid = _numpy_compact(mask, out_size)
    for fn in (compact_masked_reference, compact_masked):
        idx, valid = fn(torch.from_numpy(mask), out_size)
        assert idx.dtype == torch.int32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(valid.numpy(), want_valid)
    for fn in (append_slots_reference, append_slots):
        slots, count = fn(torch.from_numpy(num_points), torch.from_numpy(mask))
        assert slots.dtype == torch.int32 and count.dtype == torch.int32
        np.testing.assert_array_equal(slots.numpy(), num_points[:, None] + np.cumsum(mask, axis=1) - 1)
        np.testing.assert_array_equal(count.numpy(), mask.sum(axis=1))


def test_mask_scan_cpu_tensors_never_launch_the_kernel():
    mask, num_points = mask_case(2, 5000, 0.5, seed=3)
    before = mask_scan_kernel.launches
    compact_masked(torch.from_numpy(mask), 100)
    append_slots(torch.from_numpy(num_points), torch.from_numpy(mask))
    assert mask_scan_kernel.launches == before
    with pytest.raises(ValueError):  # the kernel itself takes a CUDA mask only
        mask_scan_kernel.compact(torch.from_numpy(mask), 100)


def _knn_pair(src, tgt, valid=None):
    dj, ij = jax_knn_reference(jnp.asarray(src), jnp.asarray(tgt),
                               None if valid is None else jnp.asarray(valid))
    dt, it = knn_reference(torch.from_numpy(src), torch.from_numpy(tgt),
                           None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    return dt, it


@pytest.mark.parametrize("S,T,frac_invalid", [(200, 500, 0.0), (200, 500, 0.3), (321, 777, 0.3)])
def test_knn_reference_equals_jax(S, T, frac_invalid):
    rng = np.random.default_rng(S + T)
    src = rng.uniform(-1, 1, (2, S, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, T, 3)).astype(np.float32)
    valid = rng.random((2, T)) >= frac_invalid
    _, it = _knn_pair(src, tgt, valid)
    assert valid[np.arange(2)[:, None], it.numpy()].all()


def test_knn_all_invalid_is_inf_and_zero():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((2, 30, 3)).astype(np.float32)
    tgt = rng.standard_normal((2, 40, 3)).astype(np.float32)
    dt, it = _knn_pair(src, tgt, np.zeros((2, 40), bool))
    assert torch.isinf(dt).all() and (it == 0).all()


def test_knn_duplicate_targets_lowest_index():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((1, 50, 3)).astype(np.float32)
    tgt = rng.standard_normal((1, 60, 3)).astype(np.float32)
    _, it = _knn_pair(src, np.concatenate([tgt, tgt], 1))
    assert int(it.max()) < 60


def test_knn_with_prepared_targets():
    rng = np.random.default_rng(3)
    src = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 90, 3)).astype(np.float32)
    valid = rng.random((2, 90)) > 0.25
    prep = prepare_targets(torch.from_numpy(tgt), torch.from_numpy(valid))
    assert isinstance(prep, KnnTargets) and prep.num_targets == 90
    assert tuple(prep.packed.shape) == (2, 90, 4)
    np.testing.assert_array_equal(prep.valid.numpy(), valid)
    np.testing.assert_array_equal(prep.packed[..., 3].numpy(), np.where(valid, 0.0, np.inf))
    dt, it = knn(torch.from_numpy(src), prep)
    dj, ij = jax_knn(jnp.asarray(src), jax_prepare_targets(jnp.asarray(tgt), jnp.asarray(valid)),
                     use_pallas=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_knn_outputs_detached_and_float64():
    src = torch.rand((1, 5, 3), dtype=torch.float64, requires_grad=True)
    d, i = knn(src, src.detach() + 0.1)
    assert d.dtype == torch.float64 and not d.requires_grad and i.dtype == torch.int32
    with pytest.raises(ValueError):
        knn(torch.zeros((2, 3)), torch.zeros((1, 4, 3)))


def test_knn_cpu_tensors_never_launch_the_kernel():
    before = knn_kernel.launches
    knn(torch.rand((1, 8, 3)), torch.rand((1, 9, 3)))
    assert knn_kernel.launches == before



def _mask(kind, B, T, rng):
    if kind == "random":
        return rng.random((B, T)) > 0.4
    if kind == "prefix":
        return np.arange(T)[None, :] < np.array([T // 3, T, 0][:B])[:, None]
    if kind == "all invalid":
        return np.zeros((B, T), bool)
    return np.ones((B, T), bool)


@pytest.mark.parametrize("kind", ["random", "prefix", "all invalid", "all valid"])
def test_prepare_targets_limit(kind):
    """``limit`` is one past the last valid target (0 with none), (B,) int32."""
    rng = np.random.default_rng(7)
    valid = _mask(kind, 3, 97, rng)
    prep = prepare_targets(torch.from_numpy(rng.random((3, 97, 3)).astype(np.float32)),
                           torch.from_numpy(valid))
    want = [int(np.flatnonzero(v).max()) + 1 if v.any() else 0 for v in valid]
    assert prep.limit.dtype == torch.int32 and prep.limit.tolist() == want
    if kind == "prefix":
        assert prep.limit.tolist() == valid.sum(1).tolist()  # the main path's layout
    unmasked = prepare_targets(torch.zeros((3, 97, 3)))
    assert unmasked.limit.tolist() == [97] * 3


@pytest.mark.parametrize("counts", [(1776, 1776), (1060, 2088), (5120, 0), (1, 4)])
def test_knn_prefix_layout_equals_jax(counts):
    """The main path's layout: the valid targets a prefix of the buffer."""
    rng = np.random.default_rng(sum(counts))
    T = 5120
    src = rng.uniform(-2, 2, (2, 300, 3)).astype(np.float32)
    tgt = rng.uniform(-2, 2, (2, T, 3)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array(counts)[:, None]
    prep = prepare_targets(torch.from_numpy(tgt), torch.from_numpy(valid))
    assert prep.limit.tolist() == list(counts)
    dt, it = knn(torch.from_numpy(src), prep)
    dj, ij = jax_knn(jnp.asarray(src), jax_prepare_targets(jnp.asarray(tgt), jnp.asarray(valid)),
                     use_pallas=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() < np.maximum(np.array(counts), 1)[:, None]).all()


def test_knn_on_golden_clip_main_path_inputs_equals_jax(monkeypatch):
    """The sources and targets of the first KNN call of each frame step of
    ``PointFusion()`` on the golden clip, as ``_localize`` builds them:
    the valid targets are a prefix (``limit`` is their count), and the port
    and JAX give equal indices and equal distances, to the last bit."""
    data = pathlib.Path(__file__).parent / "data" / "msrd_b2s3"
    c, d, K = (np.load(data / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics"))
    calls = []
    real_knn = icputils.knn

    def recording_knn(src, tgt, tgt_valid=None):
        if len(calls) % 2 == 0:  # numiters=1: two calls a frame step, keep the first
            calls.append((src.detach().clone(), tgt))
        else:
            calls.append(None)
        return real_knn(src, tgt, tgt_valid)

    monkeypatch.setattr(icputils, "knn", recording_knn)
    PointFusion(numiters=1, device="cpu")(RGBDImages(c, d, K, device="cpu"))
    firsts = [call for call in calls if call is not None]
    assert len(firsts) == c.shape[1] - 1
    for src, prep in firsts:
        valid = prep.valid.numpy()
        assert prep.limit.tolist() == valid.sum(1).tolist()
        assert 0 < valid.sum() < valid.size
        dt, it = knn(src, prep)
        dj, ij = jax_knn(jnp.asarray(src.numpy()),
                         jax_prepare_targets(jnp.asarray(prep.tgt.numpy()), jnp.asarray(valid)),
                         use_pallas=False)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_counted_kernels_are_the_four_wrappers():
    """The registry that captured graphs read holds each counted wrapper by
    its name, and the span marks are not counted."""
    assert cuda_build.COUNTED == {"knn": knn_kernel, "winner": winner_kernel, "mask_scan": mask_scan_kernel,
                                  "icp_system": icp_system_kernel}
    assert all(k.name == name for name, k in cuda_build.COUNTED.items())
    assert profiling._library.name is None and profiling._library not in cuda_build.COUNTED.values()


def test_a_second_wrapper_of_a_name_leaves_the_registry_as_it_is():
    """A wrapper constructed after the module's own (as a test makes one)
    leaves the module's registered, so the graphs keep counting its launches."""
    before = dict(cuda_build.COUNTED)
    _WinnerKernel()
    assert cuda_build.COUNTED == before and cuda_build.COUNTED["winner"] is winner_kernel


def test_importing_the_package_builds_and_loads_no_library():
    """Every module of the package imported in a fresh process: no library
    loaded, no compiler started, every CUDA library still unloaded."""
    code = """
import ctypes, importlib, pkgutil, subprocess
import torch
loaded, started = [], []
cdll_init, popen_init = ctypes.CDLL.__init__, subprocess.Popen.__init__
ctypes.CDLL.__init__ = lambda self, name, *a, **k: (loaded.append(name), cdll_init(self, name, *a, **k))[1]
subprocess.Popen.__init__ = lambda self, args, *a, **k: (started.append(args), popen_init(self, args, *a, **k))[1]
import gradslam_tpu_torch
for m in pkgutil.walk_packages(gradslam_tpu_torch.__path__, "gradslam_tpu_torch."):
    importlib.import_module(m.name)
from gradslam_tpu_torch.ops.winner import _WinnerKernel
from gradslam_tpu_torch.utils import cuda_build, profiling
libs = [*cuda_build.COUNTED.values(), profiling._library]
print(loaded, started, sorted(k.source for k in libs if k._fns is not None), len(libs))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=pathlib.Path(__file__).parents[1])
    assert out.stdout.split("\n")[-2] == "[] [] [] 5"


def test_launch_counts_snapshot_restore_and_add():
    """The counts as a captured graph keeps them: a snapshot before the
    capture, restored after it (a capture launches nothing), and the
    capture's calls added at every replay."""
    saved = cuda_build.launch_counts()
    try:
        before = cuda_build.launch_counts()
        knn_kernel.launches += 2  # the calls made while a graph is captured
        icp_system_kernel.launches += 8
        captured = cuda_build.launch_counts()
        cuda_build.restore_launch_counts(before)
        assert cuda_build.launch_counts() == before
        per_replay = {name: n - before[name] for name, n in captured.items()}
        assert per_replay == {"knn": 2, "winner": 0, "mask_scan": 0, "icp_system": 8}
        for _ in range(3):
            cuda_build.add_launch_counts(per_replay)
        assert cuda_build.launch_counts() == {name: n + 3 * per_replay[name] for name, n in before.items()}
    finally:
        cuda_build.restore_launch_counts(saved)
