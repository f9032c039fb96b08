"""gradslam_tpu_torch.ops against gradslam_tpu.ops.

``compact_masked`` must equal both JAX methods exactly. The plain KNN must
give the JAX plain KNN's indices and distances exactly: both compute
``(dx*dx + dy*dy) + dz*dz`` with one rounding per operation and take the
first minimum. The CUDA kernel against the plain version needs the card:
those tests are in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu.ops import knn as jax_knn
from gradslam_tpu.ops import knn_reference as jax_knn_reference
from gradslam_tpu.ops import prepare_targets as jax_prepare_targets
from gradslam_tpu.ops.masking import compact_masked as jax_compact_masked
from gradslam_tpu_torch.ops import (
    KnnTargets,
    compact_masked,
    knn,
    knn_kernel,
    knn_reference,
    prepare_targets,
)

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

