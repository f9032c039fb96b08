"""The port's CUDA kernels and main path on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): each
carries the ``cuda`` marker and skips without a card. The file imports no
JAX, so it also runs where only PyTorch is installed:

    GRADSLAM_TPU_TEST_REAL=1 python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels and their plain versions must agree bit for bit
(KNN indices and distances, winner slots); the main path on the card must
match the same run on the CPU to 1e-4 in the poses (float32 sums in another
order).
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

from gradslam_tpu_torch import PointFusion, RGBDImages, clear_graphs, disable_graphs
from gradslam_tpu_torch.ops import (
    append_slots,
    append_slots_reference,
    compact_masked,
    compact_masked_reference,
    icp_system,
    icp_system_kernel,
    knn,
    knn_kernel,
    knn_reference,
    mask_scan_kernel,
    pixel_winner,
    pixel_winner_reference,
    winner_keys,
    winner_kernel,
)
from tests.icp_cases import ICP_CASES, gradicp_kwargs, icp_case, sums_scale, torch_case
from tests.mask_cases import MASK_EDGES, mask_case

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
    for T in (256, 5120):  # every run of 8 targets the same: the first run keeps the tie
        d, i = knn(src, tgt[:, :8].repeat(1, T // 8, 1))
        assert int(i.max()) < 8


# (B, S, T, valid counts of a prefix, or None for 30% invalid and scattered)
KNN_LAYOUTS = {
    "scannet prefix": (2, 4800, 19456, [6229, 6229]),
    "golden prefix": (2, 1200, 5120, [1776, 1060]),
    "limit 0 beside a full entry": (2, 1200, 5120, [5120, 0]),
    "ragged": (3, 1000, 1000, None),
    "T=1": (3, 77, 1, None),
    "S=1": (3, 1, 5000, None),
    "large T": (2, 1200, 200_000, None),
}


@pytest.mark.parametrize("layout", list(KNN_LAYOUTS))
def test_knn_kernel_layouts_equal_plain_version(cuda_device, layout):
    """The main path's valid prefix, an empty batch entry, ragged and large
    sizes: one launch a call, bit-equal to the plain version."""
    B, S, T, counts = KNN_LAYOUTS[layout]
    gen = np.random.default_rng(S + T)
    src, tgt = _cloud(gen, (B, S, 3), cuda_device), _cloud(gen, (B, T, 3), cuda_device)
    if counts is None:
        valid = torch.from_numpy(gen.random((B, T)) > 0.3).to(cuda_device)
    else:
        valid = torch.arange(T, device=cuda_device)[None, :] < torch.tensor(counts, device=cuda_device)[:, None]
    before = knn_kernel.launches
    d, i = knn(src, tgt, valid)
    assert knn_kernel.launches == before + 1
    dp, ip = knn_reference(src, tgt, valid)
    assert torch.equal(i, ip) and torch.equal(d, dp)


def test_knn_kernel_rejects_what_it_does_not_take(cuda_device):
    src = torch.rand((1, 8, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        knn(src, src)
    limit = torch.full((1,), 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        knn_kernel(torch.rand((1, 8, 3), device=cuda_device), torch.rand((1, 8, 3), device=cuda_device), limit)
    with pytest.raises(TypeError):
        knn_kernel(torch.rand((1, 8, 3), device=cuda_device), torch.rand((1, 8, 4), device=cuda_device),
                   limit.long())


def _winner_inputs(gen, B, N, P, dev, ties=False):
    pix = gen.integers(0, P + 1, (B, N)).astype(np.int32)  # P: no pixel
    if ties:
        cc = gen.choice(np.array([0.0, 0.5, 1.0], np.float32), (B, N))
        ray = gen.choice(np.array([0.0, 1e-4, 3.0], np.float32), (B, N))
        cc[:, ::5] = -0.0
    else:
        cc = gen.uniform(0.01, 20.0, (B, N)).astype(np.float32)
        ray = gen.uniform(0.0, 0.01, (B, N)).astype(np.float32)
    k_hi, k_lo = winner_keys(torch.from_numpy(cc).to(dev), torch.from_numpy(ray).to(dev))
    slot = torch.from_numpy(np.stack([gen.permutation(N) for _ in range(B)]).astype(np.int32)).to(dev)
    return torch.from_numpy(pix).to(dev), k_hi, k_lo, slot


@pytest.mark.parametrize("B,N,P,ties", [(2, 38400, 19200, False), (2, 115200, 76800, True), (1, 999, 7, True)])
def test_winner_kernel_equals_plain_version(cuda_device, B, N, P, ties):
    args = _winner_inputs(np.random.default_rng(N), B, N, P, cuda_device, ties)
    before = winner_kernel.launches
    got = pixel_winner(*args, P, 10**6)
    assert winner_kernel.launches == before + 1
    assert torch.equal(got, pixel_winner_reference(*args, P, 10**6))


def test_winner_kernel_edge_cases(cuda_device):
    gen = np.random.default_rng(3)
    pix, k_hi, k_lo, slot = _winner_inputs(gen, 2, 5000, 300, cuda_device)
    dumped = torch.full_like(pix, 300)
    assert (pixel_winner(dumped, k_hi, k_lo, slot, 300, 5000) == 5000).all()
    one = torch.full_like(pix, 17)  # every candidate on one pixel
    assert torch.equal(pixel_winner(one, k_hi, k_lo, slot, 300, 5000),
                       pixel_winner_reference(one, k_hi, k_lo, slot, 300, 5000))
    empty = pix[:, :0]
    assert (pixel_winner(empty, empty, empty, empty, 300, 7) == 7).all()


@pytest.mark.parametrize("blocks", ["1", "7", "66", "132", "grid", "max"])
def test_winner_kernel_grids_equal_plain_version(cuda_device, blocks):
    """Every block count that tools/winner_tiles.py sweeps, at the diag's
    shapes with ties: bit-equal to the plain version (with few blocks most
    candidates are read again for the second fold). More blocks than the
    card holds at once raise."""
    B, N, P = 2, 153_600, 76_800
    args = _winner_inputs(np.random.default_rng(11), B, N, P, cuda_device, ties=True)
    winner_kernel.load()
    most = winner_kernel.max_blocks()
    n = {"grid": winner_kernel.grid(B, N, P, most), "max": most}.get(blocks) or int(blocks)
    got = winner_kernel.launch(*args, P, N, blocks=n)
    assert torch.equal(got, pixel_winner_reference(*args, P, N))
    with pytest.raises(ValueError):
        winner_kernel.launch(*args, P, N, blocks=most + 1)


def test_winner_kernel_tables_stay_clean_across_calls(cuda_device):
    """The key tables are reset by the call after the one that used them:
    calls of growing, shrinking and growing sizes on one stream, each
    bit-equal to the plain version."""
    gen = np.random.default_rng(12)
    for B, N, P in ((2, 38_400, 19_200), (2, 153_600, 76_800), (1, 999, 7), (3, 40_000, 19_999),
                    (2, 153_600, 76_800), (2, 38_400, 19_200)):
        args = _winner_inputs(gen, B, N, P, cuda_device, ties=True)
        assert torch.equal(pixel_winner(*args, P, N), pixel_winner_reference(*args, P, N))


# (B, N, P, pixel draw): "range" draws from [0, P], "wild" from [-P, 2P)
WINNER_EDGES = {
    "480x640 N=2P": (2, 614_400, 307_200, "range"),
    "ragged P": (2, 153_600, 76_801, "range"),
    "B=1": (1, 153_600, 76_800, "range"),
    "B=3 ragged": (3, 40_000, 19_999, "range"),
    "pixels out of range": (2, 38_400, 19_200, "wild"),
}


@pytest.mark.parametrize("case", list(WINNER_EDGES))
def test_winner_kernel_shapes_equal_plain_version(cuda_device, case):
    B, N, P, draw = WINNER_EDGES[case]
    gen = np.random.default_rng(N + P)
    pix, k_hi, k_lo, slot = _winner_inputs(gen, B, N, P, cuda_device, ties=True)
    if draw == "wild":
        pix = torch.from_numpy(gen.integers(-P, 2 * P, (B, N)).astype(np.int32)).to(cuda_device)
    got = pixel_winner(pix, k_hi, k_lo, slot, P, N)
    assert torch.equal(got, pixel_winner_reference(pix, k_hi, k_lo, slot, P, N))


@pytest.mark.parametrize("hot", ["one pixel", "300 pixels"])
def test_winner_kernel_hot_pixels(cuda_device, hot):
    """Every candidate on one pixel, or on 300 pixels, with slots up to
    2^31 - 2 and the sentinel 2^31 - 1."""
    B, N, P = 2, 153_600, 76_800
    gen = np.random.default_rng(5)
    _, k_hi, k_lo, _ = _winner_inputs(gen, B, N, P, cuda_device, ties=True)
    slot = torch.from_numpy(gen.integers(2**31 - 2**16, 2**31 - 1, (B, N)).astype(np.int32)).to(cuda_device)
    if hot == "one pixel":
        pix = torch.full((B, N), 4321, dtype=torch.int32, device=cuda_device)
    else:
        pix = torch.from_numpy(gen.integers(0, 300, (B, N)).astype(np.int32)).to(cuda_device)
    got = pixel_winner(pix, k_hi, k_lo, slot, P, 2**31 - 1)
    assert torch.equal(got, pixel_winner_reference(pix, k_hi, k_lo, slot, P, 2**31 - 1))


def test_winner_kernel_after_a_refused_launch(cuda_device):
    """A launch the card refuses (more blocks than it holds) leaves its
    error pending in the kernel library's runtime. The calls after it
    still launch, raise nothing and are bit-equal to the plain version."""
    B, N, P = 2, 38_400, 19_200
    gen = np.random.default_rng(13)
    args = _winner_inputs(gen, B, N, P, cuda_device, ties=True)
    pixel_winner(*args, P, N)
    fn = winner_kernel.load()["gst_pixel_winner"]
    out = torch.empty((B, P), dtype=torch.int32, device=cuda_device)
    best = torch.full((B * P,), -1, dtype=torch.int64, device=cuda_device)
    err = fn(*(t.data_ptr() for t in args), best.data_ptr(), best.data_ptr(), 0, out.data_ptr(), B, N, P, N,
             winner_kernel.max_blocks() + 1, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    for _ in range(3):
        args = _winner_inputs(gen, B, N, P, cuda_device, ties=True)
        assert torch.equal(pixel_winner(*args, P, N), pixel_winner_reference(*args, P, N))


@pytest.mark.parametrize("assoc", ["knn", "projective"])
def test_winner_kernel_on_the_main_paths_inputs(cuda_device, assoc):
    """Every selection of a PointFusion run on the golden clip, captured as
    the fusion step hands it to the kernel: bit-equal to the plain version.
    The run is eager (a captured step calls the wrapper only while it is
    captured); ``test_captured_frame_step_equals_the_eager_one`` holds the
    graphed runs to the eager ones."""
    from gradslam_tpu_torch.slam import fusionutils

    colors, depths, K = _clip()
    calls, real = [], fusionutils.pixel_winner

    def recording(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    options = {"assoc": "projective", "assoc_window": 2 * 120 * 160} if assoc == "projective" else {}
    fusionutils.pixel_winner = recording
    try:
        with disable_graphs():
            PointFusion(device=cuda_device, **options)(RGBDImages(colors, depths, K, device=cuda_device))
    finally:
        fusionutils.pixel_winner = real
    assert len(calls) == colors.shape[1]
    for pix, k_hi, k_lo, slot, P, sentinel in calls:
        assert torch.equal(pixel_winner(pix, k_hi, k_lo, slot, P, sentinel),
                           pixel_winner_reference(pix, k_hi, k_lo, slot, P, sentinel))


def test_winner_kernel_is_one_device_operation(cuda_device):
    """One selection is one CUDA kernel on the card: no memset, no other
    kernel (the key tables were set up by the call before)."""
    from torch.profiler import ProfilerActivity, profile

    args = _winner_inputs(np.random.default_rng(7), 2, 153_600, 76_800, cuda_device)
    pixel_winner(*args, 76_800, 10**6)  # builds and loads the kernel, sets up the tables
    torch.cuda.synchronize()
    before = winner_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pixel_winner(*args, 76_800, 10**6)
        torch.cuda.synchronize()
    assert winner_kernel.launches == before + 1
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_ops) == 1 and "winner_grid" in device_ops[0], device_ops


def test_winner_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        winner_kernel(x, x, x, x.long(), 4, 8)
    with pytest.raises(ValueError):
        winner_kernel(x, x, x, x[:, ::2], 4, 8)
    with pytest.raises(ValueError):
        winner_kernel(x, x, x, x.cpu(), 4, 8)


# the main path's shapes: arena-wide compaction (seq64's arena, past
# out_size; the online session's, inside it), the odometry targets over
# the carried active set, a frame's appends (out_size None: slots) and
# compact_map's whole arena
MASK_MAIN_PATH = {
    "arena seq64": (2, 4_915_200, 153_600, 0.05),
    "arena online": (1, 7_680_000, 153_600, 0.015),
    "odometry targets": (2, 230_400, 19_456, 0.1),
    "appends": (2, 76_800, None, 0.4),
    "compact_map": (2, 1_228_800, 1_228_800, 0.6),
}


def _mask_scan_equal(mask, num_points, out_size):
    """The kernel (through the public functions) against the plain versions:
    bit-equal, one call each."""
    before = mask_scan_kernel.launches
    if out_size is None:
        got, want = append_slots(num_points, mask), append_slots_reference(num_points, mask)
    else:
        got, want = compact_masked(mask, out_size), compact_masked_reference(mask, out_size)
    assert mask_scan_kernel.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", list(MASK_MAIN_PATH) + list(MASK_EDGES))
def test_mask_scan_kernel_equals_plain_version(cuda_device, case):
    B, N, out_size, share = {**MASK_MAIN_PATH, **MASK_EDGES}[case]
    mask, num_points = mask_case(B, N, share, seed=N + B)
    mask = torch.from_numpy(mask).to(cuda_device)
    num_points = torch.from_numpy(num_points).to(cuda_device)
    _mask_scan_equal(mask, num_points, out_size)
    if out_size is not None:
        _mask_scan_equal(mask, num_points, None)


@pytest.mark.parametrize("out_size", [30_000, 300_000])
def test_mask_scan_kernel_counts_equal_plain_version(cuda_device, out_size):
    """The wrapper's own outputs across many tiles: the indices, and the
    row counts (cut at ``out_size``) that the last tile of a row writes."""
    mask, num_points = mask_case(3, 100_003, 0.5, seed=out_size)
    mask = torch.from_numpy(mask).to(cuda_device)
    num_points = torch.from_numpy(num_points).to(cuda_device)
    idx, count = mask_scan_kernel.compact(mask, out_size)
    want_idx, want_valid = compact_masked_reference(mask, out_size)
    assert torch.equal(idx, want_idx) and torch.equal(count, want_valid.sum(dim=1, dtype=torch.int32))
    slots, count = mask_scan_kernel.slots(mask, num_points)
    assert all(torch.equal(g, w) for g, w in zip((slots, count), append_slots_reference(num_points, mask)))


def test_mask_scan_kernel_at_a_misaligned_row_start(cuda_device):
    """A contiguous mask whose rows start off a 16-byte boundary takes the
    byte loads: row 0 at an odd address, rows 1.. at ragged ones."""
    mask, num_points = mask_case(2, 30_001, 0.5, seed=5)
    flat = torch.zeros(mask.size + 1, dtype=torch.bool, device=cuda_device)
    flat[1:] = torch.from_numpy(mask.reshape(-1)).to(cuda_device)
    shifted = flat[1:].view(mask.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    _mask_scan_equal(shifted, torch.from_numpy(num_points).to(cuda_device), 20_000)
    _mask_scan_equal(shifted, torch.from_numpy(num_points).to(cuda_device), None)


def test_mask_scan_kernel_in_a_captured_graph(cuda_device):
    """Both epilogues captured into one CUDA graph and replayed twice on new
    masks: each replay equal to the plain version; the capture counts its
    two calls, a replay (outside the port's graphs) none."""
    B, N = 2, 230_400
    static = torch.zeros((B, N), dtype=torch.bool, device=cuda_device)
    num_points = torch.full((B,), 7, dtype=torch.int32, device=cuda_device)
    compact_masked(static, 19_456), append_slots(num_points, static)  # build, load, warm the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = mask_scan_kernel.launches
    with torch.cuda.graph(graph):
        out = compact_masked(static, 19_456) + append_slots(num_points, static)
    assert mask_scan_kernel.launches == before + 2
    for seed in (1, 2):
        static.copy_(torch.from_numpy(mask_case(B, N, 0.1, seed)[0]).to(cuda_device))
        graph.replay()
        want = compact_masked_reference(static, 19_456) + append_slots_reference(num_points, static)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_mask_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    mask = torch.zeros((2, 64), dtype=torch.bool, device=cuda_device)
    num_points = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        mask_scan_kernel.compact(mask.to(torch.uint8), 8)
    with pytest.raises(ValueError):
        mask_scan_kernel.compact(mask[:, ::2], 8)
    with pytest.raises(ValueError):
        mask_scan_kernel.compact(mask.cpu(), 8)
    with pytest.raises(ValueError):
        mask_scan_kernel.slots(mask, num_points.cpu())
    with pytest.raises(TypeError):
        mask_scan_kernel.slots(mask, num_points.long())
    with pytest.raises(ValueError):
        mask_scan_kernel.compact(mask[None], 8)
    with pytest.raises(ValueError):
        mask_scan_kernel.compact(mask, -1)


def _icp_buffers(src):
    B, S = src.shape[:2]
    f = dict(dtype=torch.float32, device=src.device)
    return (torch.empty((B, icp_system.num_blocks(S), icp_system.TERMS), **f), torch.empty((B, 6), **f),
            torch.empty((B,), **f), torch.empty_like(src))


@pytest.mark.parametrize("B,S,T", [(2, 4800, 19456), (1, 1000, 3000), (3, 300, 200), (1, 1, 5)])
@pytest.mark.parametrize("gates", [dict(), dict(dist_thresh=0.002, robust_delta=0.01)])
def test_icp_system_kernels_equal_plain_version(cuda_device, B, S, T, gates):
    """Each pass against its plain version on the same inputs: the block
    sums within float32 rounding of each sum's scale, the lookahead's solve
    and step close, and the update's moved sources bit-equal to
    ``transform_pointcloud`` at the pose the update wrote."""
    from gradslam_tpu_torch.geometry import se3_exp, transform_pointcloud
    from gradslam_tpu_torch.ops import prepare_targets

    p = torch_case(icp_case(B, S, T, seed=S, n_valid=max(1, 3 * T // 4), changes=("invalid sources",)),
                   cuda_device)
    src, packed = p["src"], torch.cat([p["tgt"], p["tgt_n"]], -1)
    dist, idx = knn(src, prepare_targets(p["tgt"], p["tgt_valid"]))
    args = (src, dist, idx, packed, p["src_valid"], gates.get("dist_thresh"), gates.get("robust_delta"))
    partials, xi, err, one_step = _icp_buffers(src)
    want = partials.clone()
    before = icp_system_kernel.launches
    icp_system.linearize(*args, partials)
    icp_system.linearize_reference(*args, want)
    f64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    want64 = want.double()
    icp_system.linearize_reference(*f64, want64)
    scale = sums_scale(want64.sum(1))
    for got in (partials, want):
        assert bool(((got.sum(1).double() - want64.sum(1)).abs() <= 1e-5 * scale + 1e-30).all())
    damp = torch.full((B,), 1e-3, device=cuda_device)
    ref = _icp_buffers(src)[1:]
    icp_system.lookahead(src, partials, damp, xi, err, one_step)
    icp_system.lookahead_reference(src, partials, damp, *ref)
    assert torch.allclose(xi, ref[0], rtol=1e-4, atol=1e-7) and torch.allclose(err, ref[1], rtol=1e-5, atol=0)
    assert torch.allclose(one_step, transform_pointcloud(src, se3_exp(xi)), rtol=0, atol=1e-6)
    moved, transform = src.clone(), torch.eye(4, device=cuda_device).repeat(B, 1, 1)
    new_damp = damp.clone()
    gates_ = icp_system.Gates.of(2.0, 1.0, 1.0, 200.0)
    icp_system.update(moved, partials, xi, err, new_damp, transform, gates_)
    assert icp_system_kernel.launches == before + 3
    assert torch.equal(moved, transform_pointcloud(src, transform))
    ref_src, ref_t, ref_damp = src.clone(), torch.eye(4, device=cuda_device).repeat(B, 1, 1), damp.clone()
    icp_system.update_reference(ref_src, partials, xi, err, ref_damp, ref_t, gates_)
    assert torch.allclose(transform, ref_t, rtol=0, atol=1e-6) and torch.allclose(new_damp, ref_damp, rtol=1e-6)


def _gradicp(p, name, numiters=20):
    from gradslam_tpu_torch.odometry import point_to_plane_gradICP

    return point_to_plane_gradICP(p["src"], p["tgt"], p["tgt_n"], numiters=numiters, **gradicp_kwargs(p, name))


def _gradicp_composition(p, name, numiters=20):
    """The op-by-op composition, which the card takes only under a gradient."""
    from gradslam_tpu_torch.odometry import icputils

    kw = gradicp_kwargs(p, name)
    solve = icputils._knn_solver(p["tgt"], p["tgt_n"], kw.get("dist_thresh"), kw["src_valid"], kw["tgt_valid"],
                                 kw.get("robust_delta"))
    lm = {k: kw.get(k, d) for k, d in (("lambda_max", 2.0), ("B", 1.0), ("B2", 1.0), ("nu", 200.0))}
    return icputils._gradicp_loop(solve, p["src"], kw.get("initial_transform"), numiters, 1e-8, **lm)


@pytest.mark.parametrize("case", list(ICP_CASES))
def test_fused_gradicp_equals_the_composition(cuda_device, case):
    """point_to_plane_gradICP on the card (the kernels) against the op-by-op
    composition on the card: within 1e-5 in every pose entry."""
    p = torch_case(icp_case(2, 4800, 19456, seed=len(case), n_valid=6229, changes=ICP_CASES[case][1]),
                   cuda_device)
    got, want = _gradicp(p, case), _gradicp_composition(p, case)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-5


def test_fused_gradicp_is_batch_independent_and_repeats(cuda_device):
    """A batch element's pose has the same bits alone and in a batch of 2,
    and two runs give the same bits."""
    p = torch_case(icp_case(2, 4800, 19456, seed=9, n_valid=6229, changes=("invalid sources",)), cuda_device)
    both = _gradicp(p, "all gates")
    assert torch.equal(both, _gradicp(p, "all gates"))
    for b in range(2):
        alone = {k: v[b : b + 1] for k, v in p.items()}
        assert torch.equal(_gradicp(alone, "all gates"), both[b : b + 1])


def test_fused_gradicp_in_a_captured_graph(cuda_device):
    """The fused loop captured into one CUDA graph and replayed on new
    sources: each replay bit-equal to the eager run."""
    p = torch_case(icp_case(2, 4800, 19456, seed=2, n_valid=6229), cuda_device)
    static = {k: v.clone() for k, v in p.items()}
    _gradicp(static, "all gates")  # build, load, warm the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _gradicp(static, "all gates")
    for seed in (3, 4):
        q = torch_case(icp_case(2, 4800, 19456, seed=seed, n_valid=6229), cuda_device)
        for k in static:
            static[k].copy_(q[k])
        graph.replay()
        assert torch.equal(out, _gradicp(q, "all gates"))


def test_fused_gradicp_launch_counts(cuda_device):
    """2 KNN and 4 icp_system launches an iteration; with an input that
    requires grad, the composition: 2 KNN launches an iteration and no
    icp_system launch."""
    p = torch_case(icp_case(2, 1000, 3000, seed=1), cuda_device)
    before = (knn_kernel.launches, icp_system_kernel.launches)
    _gradicp(p, "plain", numiters=5)
    assert (knn_kernel.launches - before[0], icp_system_kernel.launches - before[1]) == (10, 20)
    p["src"].requires_grad_()
    before = (knn_kernel.launches, icp_system_kernel.launches)
    T = _gradicp(p, "plain", numiters=5)
    assert (knn_kernel.launches - before[0], icp_system_kernel.launches - before[1]) == (10, 0)
    assert T.requires_grad


def test_icp_system_kernel_rejects_what_it_does_not_take(cuda_device):
    p = torch_case(icp_case(2, 300, 400, seed=1), cuda_device)
    src, packed = p["src"], torch.cat([p["tgt"], p["tgt_n"]], -1)
    dist, idx = knn(src, p["tgt"])
    partials, xi, err, one_step = _icp_buffers(src)
    lin = lambda **kw: icp_system_kernel.linearize(  # noqa: E731
        **{**dict(src=src, dist=dist, idx=idx, tgt_packed=packed, src_w=None, dist_thresh=None, robust_delta=None,
                  partials=partials), **kw})
    lin()
    with pytest.raises(TypeError):
        lin(src=src.double())
    with pytest.raises(TypeError):
        lin(idx=idx.long())
    with pytest.raises(ValueError):
        lin(tgt_packed=packed.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        lin(dist=dist.cpu())
    with pytest.raises(ValueError):
        lin(partials=partials[:, :1])
    with pytest.raises(ValueError):
        icp_system_kernel.lookahead(src, partials, torch.ones(2, device=cuda_device), xi, err, one_step.cpu())
    with pytest.raises(TypeError):
        icp_system_kernel.update(src, partials, xi, err, torch.ones(2, device=cuda_device),
                                 torch.eye(4, device=cuda_device, dtype=torch.float64).repeat(2, 1, 1),
                                 icp_system.Gates.of(2.0, 1.0, 1.0, 200.0))
    with pytest.raises(ValueError):  # the CPU's plain version takes no CUDA buffer
        icp_system.linearize(src.cpu(), dist, idx, packed, None, None, None, partials)


_CHECK_CASES = {
    "an input on the cpu": (ValueError, lambda a, b: dict(b=b.cpu())),
    "the device before the dtype": (ValueError, lambda a, b: dict(b=b.long().cpu())),
    "a dtype": (TypeError, lambda a, b: dict(b=b.long())),
    "the dtype before the shape": (TypeError, lambda a, b: dict(b=b.long()[:, :4])),
    "a rank": (ValueError, lambda a, b: dict(a=a[0])),
    "a size": (ValueError, lambda a, b: dict(a=a[..., :2].contiguous())),
    "a named size": (ValueError, lambda a, b: dict(b=b[:, :4].contiguous())),
    "the shape before contiguity": (ValueError, lambda a, b: dict(a=a[:, ::2])),
    "contiguity": (ValueError, lambda a, b: dict(a=a.transpose(0, 1).contiguous().transpose(0, 1))),
}


@pytest.mark.parametrize("case", list(_CHECK_CASES))
def test_check_inputs_error_types(cuda_device, case):
    """``cuda_build.check_inputs``, which every kernel wrapper calls: one
    CUDA device, then the dtype (TypeError), then the shape and contiguity
    (ValueError), in that order; a None input is left out."""
    from gradslam_tpu_torch.utils.cuda_build import check_inputs

    a = torch.zeros((2, 8, 3), device=cuda_device)
    b = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    error, broken = _CHECK_CASES[case]
    spec = {"a": (torch.float32, ("B", "N", 3)), "b": (torch.int32, ("B", "N")), "c": (torch.float32, (5,))}
    given = {"a": a, "b": b, "c": None}
    check_inputs("test kernel", **{n: (t, *spec[n]) for n, t in given.items()})
    with pytest.raises(error):
        check_inputs("test kernel", **{n: (t, *spec[n]) for n, t in {**given, **broken(a, b)}.items()})


def _clip():
    return tuple(np.load(DATA / f"{n}.npy").astype(np.float32) for n in ("colors", "depths", "intrinsics"))


@pytest.mark.parametrize("kw", [dict(), dict(assoc="projective", assoc_window=2 * 120 * 160)],
                         ids=["knn", "projective"])
def test_frame_loop_never_waits_on_the_host(cuda_device, kw):
    """No op of the frame loop synchronizes with the host: PyTorch's sync
    debug mode turns any such call into an error."""
    rgbd = RGBDImages(*_clip(), device=cuda_device)
    slam = PointFusion(device=cuda_device, **kw)
    slam(rgbd)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, poses = slam(rgbd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(poses).all()


@pytest.mark.parametrize("kw", [dict(), dict(assoc="projective", assoc_window=2 * 120 * 160)],
                         ids=["knn", "projective"])
def test_pointfusion_on_the_card_matches_the_cpu(cuda_device, kw):
    c, d, K = _clip()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pcs, poses = PointFusion(device=dev, **kw)(RGBDImages(c, d, K, device=dev))
        assert poses.device.type == dev.type
        out[dev.type] = (poses.cpu().numpy(), pcs.num_points_per_pointcloud.cpu().numpy())
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() < 1e-4
    assert np.all(np.abs(out["cuda"][1] - out["cpu"][1]) <= 0.005 * out["cpu"][1])


def test_winner_kernel_refuses_float64_keys(cuda_device):
    """float64 fusion keys are int64 words, which only the plain version
    takes: on the card they raise instead of running another way."""
    cc = torch.rand((1, 64), dtype=torch.float64, device=cuda_device)
    k_hi, k_lo = winner_keys(cc, cc)
    assert k_hi.dtype == torch.int64
    pix = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        pixel_winner(pix, k_hi, k_lo, pix, 4, 64)


def _calib_step(dev, L=3):
    """One ``slam_loss`` forward and backward on the golden clip (clip
    poses as the target, the depth seen by a sensor of scale 1/1.1):
    (parameter grads, depth grad, forward launches, backward launches)."""
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss

    c, d, K = (torch.from_numpy(x[:, :L] if x.ndim == 5 else x).to(dev) for x in _clip())
    gt = torch.from_numpy(np.load(DATA / "poses.npy").astype(np.float32)[:, :L]).to(dev)
    params = DepthCalibParams(device=dev)
    depth = (d / 1.1).requires_grad_(True)
    counts = lambda: (knn_kernel.launches, winner_kernel.launches)
    before = counts()
    loss = slam_loss(params, c, depth, K, gt, PointFusion(device=dev).opts, L * 120 * 160)
    mid = counts()
    loss.backward()
    after = counts()
    fwd = tuple(b - a for a, b in zip(before, mid))
    bwd = tuple(b - a for a, b in zip(mid, after))
    return torch.stack([params.scale.grad, params.bias.grad]), depth.grad, fwd, bwd


def test_training_step_on_the_card(cuda_device):
    """The forward of a training step launches both kernels (40 KNN per
    frame step, one winner per fusion step), the backward neither; the
    gradients are finite, nonzero and match the CPU's within 1e-3 of their
    largest component."""
    g, gd, fwd, bwd = _calib_step(cuda_device)
    assert fwd == (2 * 40, 3) and bwd == (0, 0)
    g_c, gd_c, _, _ = _calib_step(torch.device("cpu"))
    for card, cpu in ((g, g_c), (gd, gd_c)):
        assert torch.isfinite(card).all() and float(card.abs().max()) > 0
        assert float((card.cpu() - cpu).abs().max()) <= 1e-3 * float(cpu.abs().max())


def test_metrics_on_the_card_match_the_cpu(cuda_device):
    """On the outputs of a run on the card: ATE and RPE within 1e-6 of the
    same functions on the CPU; chamfer distance and map accuracy between
    the gradICP map and a ground-truth-odometry map run on the KNN kernel
    (4 launches) and match the CPU's plain version."""
    from gradslam_tpu_torch.metrics import ate_rmse, chamfer_distance, map_accuracy, rpe

    c, d, K = _clip()
    gt = torch.from_numpy(np.load(DATA / "poses.npy").astype(np.float32)).to(cuda_device)
    pcs, poses = PointFusion(device=cuda_device)(RGBDImages(c, d, K, device=cuda_device))
    ref, _ = PointFusion(odom="gt", device=cuda_device)(RGBDImages(c, d, K, gt, device=cuda_device))
    maps = (pcs.points_padded, ref.points_padded, pcs.nonpad_mask, ref.nonpad_mask)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        a, b, va, vb = (x.to(dev) for x in maps)
        before = knn_kernel.launches
        recon = torch.stack([chamfer_distance(a, b, va, vb), *map_accuracy(a, b, va, vb)])
        assert knn_kernel.launches - before == (4 if dev.type == "cuda" else 0)
        p, g = poses.to(dev), gt.to(dev)
        out.append((torch.stack([ate_rmse(p, g), *rpe(p, g)]).cpu(), recon.cpu()))
    (traj, recon), (traj_c, recon_c) = out
    assert torch.isfinite(traj).all() and float((traj - traj_c).abs().max()) <= 1e-6
    torch.testing.assert_close(recon, recon_c, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", ["gated", "labels", "labels projective"])
def test_gated_and_labelled_runs_on_the_card_match_the_cpu(cuda_device, path):
    """Block-gated fusion (blocks of 1024 rows) and label fusion on the
    card: the poses within 1e-4 of the CPU's, the counts within 0.5%, one
    winner launch per fusion step and 40 KNN launches per frame step on the
    KNN paths; under one constant label every live label is that label and
    its confidence the ccount."""
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence

    c, d, K = _clip()
    B, L, H, W = c.shape[:4]
    kw = dict(odom="gradicp", fusion=True)
    if path == "gated":
        kw["block_size"] = 1024
    if path == "labels projective":
        kw.update(assoc="projective", assoc_window=2 * H * W)
    labels = None if path == "gated" else np.full((B, L, H, W), 7.0, np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = lambda x: None if x is None else torch.from_numpy(x).to(dev)
        before = (knn_kernel.launches, winner_kernel.launches)
        m, poses = slam_sequence(t(c), t(d), t(K), None, SLAMOptions(**kw), L * H * W, labels_seq=t(labels))
        launches = (knn_kernel.launches - before[0], winner_kernel.launches - before[1])
        out[dev.type] = (poses.cpu().numpy(), m.num_points.cpu().numpy())
        if dev.type == "cuda":
            knn_calls = 0 if "projective" in path else (L - 1) * 40
            assert launches == (knn_calls, L)
        if labels is not None:
            for b in range(B):
                n = int(m.num_points[b])
                assert (m.labels[b, :n] == 7.0).all()
                assert torch.equal(m.label_conf[b, :n], m.ccounts[b, :n, 0])
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() < 1e-4
    assert np.all(np.abs(out["cuda"][1] - out["cpu"][1]) <= 0.005 * out["cpu"][1])


def test_find_correspondences_dense_at_scannet_capacity(cuda_device):
    """``find_correspondences_dense`` over a whole 1,228,800-row arena (16
    noisy copies of a 240x320 frame): one winner launch, bit-equal to the
    plain version on the same inputs, and the same correspondences as the
    CPU."""
    from gradslam_tpu_torch.slam import find_correspondences_dense, fusionutils
    from gradslam_tpu_torch.structures import MapState, pack_rows

    c, d, K = _clip()
    rgbd = RGBDImages(c[:, :1].repeat(2, 2).repeat(2, 3), d[:, :1].repeat(2, 2).repeat(2, 3),
                      K * np.array([2, 2, 1, 1], np.float32)[:, None], device=cuda_device)
    B, _, H, W = rgbd.shape
    gv, gn = rgbd.global_vertex_map[:, 0].reshape(B, H * W, 3), rgbd.global_normal_map[:, 0].reshape(B, H * W, 3)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    copies = 16
    pts = gv.repeat(1, copies, 1) + 1e-3 * torch.randn((B, copies * H * W, 3), generator=gen, device=cuda_device)
    cc = torch.randint(1, 4, (B, copies * H * W, 1), generator=gen, device=cuda_device).float()
    ms = MapState(pack_rows(pts, gn.repeat(1, copies, 1), torch.zeros_like(pts), cc),
                  torch.full((B,), copies * H * W, dtype=torch.int32, device=cuda_device))
    assert ms.capacity == 1_228_800
    calls, real = [], fusionutils.pixel_winner

    def recording(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    args = (rgbd.global_vertex_map[:, 0], rgbd.global_normal_map[:, 0], torch.eye(4, device=cuda_device)
            .expand(B, 4, 4), rgbd.intrinsics, 0.05, 0.93969262)
    fusionutils.pixel_winner = recording
    try:
        before = winner_kernel.launches
        corr = find_correspondences_dense(ms, *args)
        assert winner_kernel.launches == before + 1
    finally:
        fusionutils.pixel_winner = real
    (pix, k_hi, k_lo, slot, P, sentinel), = calls
    assert pix.shape == (B, 1_228_800)
    assert torch.equal(pixel_winner(pix, k_hi, k_lo, slot, P, sentinel),
                       pixel_winner_reference(pix, k_hi, k_lo, slot, P, sentinel))
    assert int(corr.pix_corr.sum()) > 0.5 * B * H * W
    cpu = find_correspondences_dense(MapState(ms.data.cpu(), ms.num_points.cpu()),
                                     *(x.cpu() if torch.is_tensor(x) else x for x in args))
    for name in ("winner", "pix_corr", "h", "w", "active"):
        assert torch.equal(getattr(corr, name).cpu(), getattr(cpu, name)), name


def test_gradicp_provider_knn_calls_are_bit_equal(cuda_device):
    """The GradICP provider on frames 0 -> 1 of the golden clip: each KNN
    call of its solve is one kernel launch, bit-equal to the plain version,
    and the transform is the CPU's within 1e-4."""
    from gradslam_tpu_torch.odometry import GradICPOdometryProvider, downsample_rgbdimages, icputils
    from gradslam_tpu_torch.structures import pointclouds_from_rgbdimages

    c, d, K = _clip()
    poses = np.load(DATA / "poses.npy").astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        frame = lambda s: RGBDImages(c[:, s : s + 1], d[:, s : s + 1], K, poses[:, s : s + 1], device=dev)
        calls, real = [], icputils.knn

        def recording(src, tgt, tgt_valid=None):
            calls.append((src.detach().clone(), tgt))
            return real(src, tgt, tgt_valid)

        icputils.knn = recording
        try:
            before = knn_kernel.launches
            T = GradICPOdometryProvider().provide(pointclouds_from_rgbdimages(frame(0)),
                                                  downsample_rgbdimages(frame(1), 4))
            launched = knn_kernel.launches - before
        finally:
            icputils.knn = real
        out[dev.type] = T.cpu()
        if dev.type == "cuda":
            assert launched == len(calls) == 40
            for src, tgt in calls:
                dk, ik = knn(src, tgt)
                dp, ip = knn_reference(src, tgt.tgt, tgt.valid)
                assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-4


def _lifecycle_clip(ds=2, L=10):
    colors = np.load(DATA / "colors.npy").astype(np.float32)
    depths = np.load(DATA / "depths.npy").astype(np.float32)
    idx = [i % colors.shape[1] for i in range(L)]
    K = np.load(DATA / "intrinsics.npy").astype(np.float32).copy()
    K[:, :, :2] /= ds
    return (np.ascontiguousarray(colors[:, idx, ::ds, ::ds]), np.ascontiguousarray(depths[:, idx, ::ds, ::ds]), K)


def test_voxel_merge_is_deterministic_and_matches_the_cpu(cuda_device):
    """No float atomics: two merges on the card are bitwise equal, and the
    cell structure (counts, validity) is the CPU's."""
    from gradslam_tpu_torch.ops import voxel_merge_rows

    gen = np.random.default_rng(0)
    rows = np.zeros((2, 200_000, 12), np.float32)
    rows[..., 0:3] = gen.uniform(-1, 1, (2, 200_000, 3))
    rows[..., 3:9] = gen.uniform(0, 1, (2, 200_000, 6))
    rows[..., 9] = gen.uniform(0.1, 2, (2, 200_000))
    live = gen.random((2, 200_000)) > 0.1
    r, l = torch.from_numpy(rows), torch.from_numpy(live)
    a, la = voxel_merge_rows(r.to(cuda_device), l.to(cuda_device), 2.0**-5)
    b, lb = voxel_merge_rows(r.to(cuda_device), l.to(cuda_device), 2.0**-5)
    c, lc = voxel_merge_rows(r, l, 2.0**-5)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert torch.equal(la.cpu(), lc)
    assert float((a.cpu() - c).abs().max()) < 1e-5


@pytest.mark.parametrize("size", [0.02, 0.01])
def test_voxel_cells_match_the_cpu_at_the_package_sizes(cuda_device, size):
    """At the package's voxel sizes (not powers of two) the card puts every
    point in the CPU's cell, points one ulp from a cell face included: the
    cell order and boundaries are bit-equal and the merged rows agree."""
    from gradslam_tpu_torch.ops import voxel

    gen = np.random.default_rng(1)
    B, N = 2, 120_000
    face = (gen.integers(-100, 100, (B, N // 2, 3)) * size).astype(np.float32)
    face = np.nextafter(face, face + gen.integers(-1, 2, face.shape).astype(np.float32))
    rows = np.zeros((B, N, 12), np.float32)
    rows[..., 0:3] = np.concatenate([gen.uniform(-2, 2, (B, N // 2, 3)), face], axis=1)
    rows[..., 3:9] = gen.uniform(0, 1, (B, N, 6))
    rows[..., 9] = gen.uniform(0.1, 2, (B, N))
    live = torch.from_numpy(gen.random((B, N)) > 0.1)
    r = torch.from_numpy(rows)
    origin = torch.zeros(3)
    card = voxel._sort_by_voxel(r[..., 0:3].to(cuda_device), live.to(cuda_device), size, origin.to(cuda_device))
    cpu = voxel._sort_by_voxel(r[..., 0:3], live, size, origin)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    a, la = voxel.voxel_merge_rows(r.to(cuda_device), live.to(cuda_device), size)
    c, lc = voxel.voxel_merge_rows(r, live, size)
    assert torch.equal(la.cpu(), lc)
    assert float((a.cpu() - c).abs().max()) <= 1e-6


@pytest.mark.parametrize("size", [0.02, 0.01])
def test_managed_poses_match_the_cpu_at_the_package_voxels(cuda_device, size):
    """A managed run compacting at every segment boundary at the package's
    voxel sizes: the card's arena counts are the CPU's and its poses within
    1e-4."""
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence_managed

    c, d, K = _lifecycle_clip()
    H, W = c.shape[2:4]
    opts = SLAMOptions(odom="gradicp", numiters=8, fusion=True)
    kw = dict(opts=opts, capacity=3 * H * W, watermark=0.1, segment_len=3, voxel_size=size)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        rgb, dep, Kt = (torch.from_numpy(x).to(dev) for x in (c, d, K))
        out[dev.type] = slam_sequence_managed(rgb, dep, Kt, None, **kw)
    (m, p), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert torch.equal(m.num_points.cpu(), m_cpu.num_points)
    assert float((p.cpu() - p_cpu).abs().max()) < 1e-4


def test_managed_resume_on_the_card(cuda_device, tmp_path):
    """The managed run on the card: its poses match the CPU's to 1e-4, and a
    checkpoint resumed at a compacting boundary with ``assoc_window`` set
    equals the uninterrupted run bit for bit."""
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence_managed
    from gradslam_tpu_torch.utils import load_slam_state, save_slam_state

    c, d, K = _lifecycle_clip()
    H, W = c.shape[2:4]
    opts = SLAMOptions(odom="gradicp", numiters=8, fusion=True, assoc_window=H * W)
    kw = dict(opts=opts, capacity=3 * H * W, watermark=0.1, segment_len=3, voxel_size=2.0**-6)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        rgb, dep, Kt = (torch.from_numpy(x).to(dev) for x in (c, d, K))
        out[dev.type] = slam_sequence_managed(rgb, dep, Kt, None, **kw)
    (m, p), (_, p_cpu) = out["cuda"], out["cpu"]
    assert float((p.cpu() - p_cpu).abs().max()) < 1e-4
    rgb, dep, Kt = (torch.from_numpy(x).to(cuda_device) for x in (c, d, K))
    m1, p1 = slam_sequence_managed(rgb[:, :4], dep[:, :4], Kt, None, **kw)
    save_slam_state(str(tmp_path / "ck.npz"), m1, p1[:, -1])
    m2, p2 = slam_sequence_managed(rgb[:, 4:], dep[:, 4:], Kt, None,
                                   resume_from=load_slam_state(str(tmp_path / "ck.npz")), **kw)
    assert torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points)
    assert torch.equal(p2, p[:, 4:])


def test_dataloader_copies_to_the_card(cuda_device):
    """``to_device`` on the card: pinned staging and a copy stream give the
    host arrays' exact values on the consumer's stream."""
    from gradslam_tpu_torch.datasets import DataLoader

    class Frames:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return np.full((4, 48, 64, 3), i, np.float32), f"f{i}"

    batches = list(DataLoader(Frames(), batch_size=2, num_workers=2, to_device="cuda"))
    assert len(batches) == 3
    for k, (x, names) in enumerate(batches):
        assert x.is_cuda and names == [f"f{2 * k}", f"f{2 * k + 1}"]
        assert torch.equal(x[:, 0, 0, 0, 0].cpu(), torch.tensor([2.0 * k, 2.0 * k + 1]))


def _loop_clouds(L=9, n_pts=256, drift=0.02, seed=0):
    """tests/slam/test_loopclosure.py's synthetic loop, made with numpy and
    the port's ``se3_exp`` on the CPU: (drifted poses, camera-frame points,
    normals, validity) as float32 arrays."""
    from gradslam_tpu_torch.geometry import se3_exp

    rng = np.random.RandomState(seed)
    world = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
    world[:, 2] += 4.0
    normals = rng.randn(n_pts, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    true_poses, frames, frame_normals = [], [], []
    for k in range(L):
        ang = 2 * np.pi * k / (L - 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = 0.15 * np.array([np.cos(ang) - 1.0, np.sin(ang), 0.0])
        true_poses.append(T)
        Tinv = np.linalg.inv(T)
        frames.append(world @ Tinv[:3, :3].T + Tinv[:3, 3])
        frame_normals.append(normals @ Tinv[:3, :3].T)
    drifted = [true_poses[0]]
    for k in range(1, L):
        inc = np.linalg.inv(true_poses[k - 1]) @ true_poses[k]
        noisy = se3_exp(torch.from_numpy(rng.randn(6).astype(np.float32) * drift)).numpy() @ inc
        drifted.append(drifted[-1] @ noisy)
    return (np.stack(drifted).astype(np.float32), np.stack(frames).astype(np.float32),
            np.stack(frame_normals).astype(np.float32), np.ones((L, n_pts), bool))


def _close_both(dev, arrays):
    from gradslam_tpu_torch.slam import close_loops, keyframe_descriptors_invariant

    dr, pts, nrm, val = (torch.from_numpy(x).to(dev) for x in arrays)
    return close_loops(dr, pts, nrm, val, max_candidates=4, min_separation=5, max_distance=0.3,
                       detection="both", descriptors=keyframe_descriptors_invariant(pts, nrm, val))


def test_close_loops_on_the_card_matches_the_cpu(cuda_device):
    """Both detectors on the card: the candidates and acceptance weights of
    the CPU, poses within 1e-4, 2 KNN launches per ICP iteration and 1 for
    the inlier scoring per detector set."""
    arrays = _loop_clouds()
    before = knn_kernel.launches
    refined, cand, w = _close_both(cuda_device, arrays)
    assert knn_kernel.launches - before == 2 * (2 * 20 + 1)
    ref, ref_cand, ref_w = _close_both(torch.device("cpu"), arrays)
    assert torch.equal(cand.edges.cpu(), ref_cand.edges) and torch.equal(cand.valid.cpu(), ref_cand.valid)
    assert torch.equal(w.cpu(), ref_w) and bool((w > 0).any())
    assert float((refined.cpu() - ref).abs().max()) < 1e-4


def test_close_loops_repeats_bit_for_bit(cuda_device):
    """No float atomics on the closure's path: two runs on the card give the
    same bits."""
    arrays = _loop_clouds(seed=7, drift=0.03)
    a = _close_both(cuda_device, arrays)
    b = _close_both(cuda_device, arrays)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_knn_kernel_at_the_multistart_shape(cuda_device):
    """The multistart verification's batch at the sensor's size: B = 8
    candidates x 7 yaw hypotheses, S = T = 19,200 (480x640 at dsratio 4),
    every target valid."""
    gen = np.random.default_rng(56)
    src, tgt = _cloud(gen, (56, 19200, 3), cuda_device), _cloud(gen, (56, 19200, 3), cuda_device)
    valid = torch.ones((56, 19200), dtype=torch.bool, device=cuda_device)
    before = knn_kernel.launches
    d, i = knn(src, tgt, valid)
    assert knn_kernel.launches == before + 1
    dp, ip = knn_reference(src, tgt, valid)
    assert torch.equal(i, ip) and torch.equal(d, dp)


def test_float64_loop_closure_raises_on_the_card(cuda_device):
    """The KNN kernel takes float32 only, and there is no fallback."""
    from gradslam_tpu_torch.slam import close_loops

    dr, pts, nrm, val = (torch.from_numpy(x).to(cuda_device) for x in _loop_clouds())
    with pytest.raises(TypeError, match="float32"):
        close_loops(dr.double(), pts.double(), nrm.double(), val, max_candidates=4, min_separation=5)


def test_refinement_on_the_card_matches_the_cpu(cuda_device):
    """``pose_graph_refine`` and ``ba_refine`` (both solvers) on the card
    within 1e-4 of the CPU."""
    from gradslam_tpu_torch.geometry import se3_exp
    from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine

    gen = np.random.default_rng(3)
    L, M = 12, 400
    poses = se3_exp(torch.from_numpy(gen.normal(0, 0.2, (L, 6)).astype(np.float32)))
    poses[0] = torch.eye(4)
    edges = torch.tensor([(i, i + 1) for i in range(L - 1)] + [(0, L - 1), (2, 9)], dtype=torch.int32)
    Z = torch.linalg.inv(poses[edges[:, 0].long()]) @ poses[edges[:, 1].long()]
    Z = se3_exp(torch.from_numpy(gen.normal(0, 0.01, (edges.shape[0], 6)).astype(np.float32))) @ Z
    g = PoseGraph(poses, edges, Z, torch.ones(edges.shape[0]))
    got = pose_graph_refine(PoseGraph(*(x.to(cuda_device) for x in g)), num_iters=5)
    assert float((got.cpu() - pose_graph_refine(g, num_iters=5)).abs().max()) < 1e-4
    lms = torch.from_numpy(gen.uniform([-1, -1, 2], [1, 1, 4], (M, 3)).astype(np.float32))
    obs_lm = torch.arange(M).repeat_interleave(4)
    obs_pose = torch.from_numpy(gen.integers(0, L, M * 4))
    Tinv = torch.linalg.inv(poses)[obs_pose]
    obs = (Tinv[:, :3, :3] @ lms[obs_lm][:, :, None])[..., 0] + Tinv[:, :3, 3]
    args = (poses, lms + 0.01, obs_pose, obs_lm, obs)
    for solver in ("dense", "pcg"):
        a = ba_refine(*(x.to(cuda_device) for x in args), num_iters=3, solver=solver)
        b = ba_refine(*args, num_iters=3, solver=solver)
        for x, y in zip(a, b):
            assert float((x.cpu() - y).abs().max()) < 1e-4, solver


def test_map_sharded_flagship_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """JAX's flagship configuration (projective association, a 2*H*W
    window) over two gloo ranks on the card, ``make_mesh(data=1, map_=2)``,
    against one process on the CPU: poses within 1e-4, ``num_points``
    equal."""
    from gradslam_tpu_torch.slam import SLAMOptions, slam_sequence
    from tests.torch_dist_worker import FLAGSHIP, golden_clip, launch

    ranks = launch("flagship_cuda2", 2, tmp_path, timeout=300.0, cuda=True)
    rgb, dep, K, _ = (torch.from_numpy(np.ascontiguousarray(x)) for x in golden_clip(2))
    B, L, H, W, _ = rgb.shape
    m, p = slam_sequence(rgb, dep, K, None, SLAMOptions(**FLAGSHIP), L * H * W)
    for got in ranks.wait():
        np.testing.assert_array_equal(got["num_points"], m.num_points.numpy())
        np.testing.assert_allclose(got["poses"], p.numpy(), atol=1e-4)


def test_knn_use_pallas_on_the_card(cuda_device):
    """``use_pallas``: None and True launch the kernel on a CUDA tensor, bit
    for bit as the plain version; False asks for the plain version on the
    card and raises."""
    gen = np.random.default_rng(11)
    src, tgt = _cloud(gen, (2, 300, 3), cuda_device), _cloud(gen, (2, 500, 3), cuda_device)
    valid = torch.from_numpy(gen.random((2, 500)) > 0.3).to(cuda_device)
    ref = knn_reference(src, tgt, valid)
    for use_pallas in (None, True):
        before = knn_kernel.launches
        d, i = knn(src, tgt, valid, use_pallas=use_pallas)
        assert knn_kernel.launches == before + 1, use_pallas
        assert torch.equal(d, ref[0]) and torch.equal(i, ref[1])
    before = knn_kernel.launches
    with pytest.raises(ValueError, match="use_pallas=False"):
        knn(src, tgt, valid, use_pallas=False)
    assert knn_kernel.launches == before


def test_directory_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """``use_orbax=True`` from card tensors, loaded back onto the card."""
    from gradslam_tpu_torch.structures import MapState
    from gradslam_tpu_torch.utils import load_slam_state, save_slam_state

    gen = torch.Generator().manual_seed(0)
    m = MapState(torch.randn(2, 64, 12, generator=gen).to(cuda_device),
                 torch.tensor([10, 64], dtype=torch.int32, device=cuda_device))
    poses = torch.randn(2, 3, 4, 4, generator=gen).to(cuda_device)
    save_slam_state(str(tmp_path / "ckpt"), m, poses, use_orbax=True)
    m2, p2 = load_slam_state(str(tmp_path / "ckpt"), use_orbax=True)
    assert m2.data.is_cuda and torch.equal(m2.data, m.data) and torch.equal(m2.num_points, m.num_points)
    assert torch.equal(p2, poses)


# the captured frame step (gradslam_tpu_torch/slam/stepgraph.py)

GRAPH_OPTIONS = {
    "knn": dict(),
    "projective dense": dict(assoc="projective", assoc_window=2 * 120 * 160, model_rows="dense"),
    "gated": dict(block_size=4096),
}


def _cycled_clip(L):
    c, d, K = _clip()
    idx = [i % c.shape[1] for i in range(L)]
    return c[:, idx], d[:, idx], K


@pytest.mark.parametrize("name", list(GRAPH_OPTIONS))
def test_captured_frame_step_equals_the_eager_one(cuda_device, name):
    """slam_sequence with its step captured and replayed, twice (the second
    sequence through the cached graph), against the same step op by op:
    0 differing elements in the poses and the arena, the same launches."""
    from gradslam_tpu_torch.slam import slam_sequence

    c, d, K = (torch.from_numpy(x).to(cuda_device) for x in _cycled_clip(6))
    opts = PointFusion(device=cuda_device, **GRAPH_OPTIONS[name]).opts
    cap = 6 * 120 * 160
    clear_graphs()
    runs = []
    for graphed in (False, True, True):
        before = (knn_kernel.launches, winner_kernel.launches)
        if graphed:
            m, p = slam_sequence(c, d, K, None, opts, cap)
        else:
            with disable_graphs():
                m, p = slam_sequence(c, d, K, None, opts, cap)
        runs.append((m, p, (knn_kernel.launches - before[0], winner_kernel.launches - before[1])))
    (m0, p0, l0) = runs[0]
    assert l0 == ((0 if name.startswith("projective") else 5 * 40), 6)
    for m, p, launches in runs[1:]:
        assert torch.equal(p, p0) and torch.equal(m.data, m0.data) and torch.equal(m.num_points, m0.num_points)
        assert launches == l0
    clear_graphs()


def test_a_host_read_in_the_captured_step_raises(cuda_device):
    """A step that reads the host cannot be captured: slam_sequence raises
    (nothing reruns the step eagerly), and the next run captures anew."""
    from gradslam_tpu_torch.slam import icpslam, slam_sequence

    c, d, K = (torch.from_numpy(x).to(cuda_device) for x in _cycled_clip(4))
    opts = PointFusion(device=cuda_device).opts
    real = icpslam._localize

    def reading(*args, **kwargs):
        pose = real(*args, **kwargs)
        float(pose.sum())
        return pose

    clear_graphs()
    icpslam._localize = reading
    try:
        with pytest.raises(Exception):
            slam_sequence(c, d, K, None, opts, 4 * 120 * 160)
    finally:
        icpslam._localize = real
    clear_graphs()
    m, p = slam_sequence(c, d, K, None, opts, 4 * 120 * 160)
    with disable_graphs():
        m0, p0 = slam_sequence(c, d, K, None, opts, 4 * 120 * 160)
    assert torch.equal(p, p0) and torch.equal(m.data, m0.data)


def test_step_state_returns_a_state_the_caller_owns_on_the_card(cuda_device):
    """ICPSLAM.step_state on the card advances the instance's static carry
    and returns a copy of it: every state kept from an earlier step, and
    states of two runs interleaved on one instance, stay bit-equal to the
    eager steps'."""
    from gradslam_tpu_torch.slam.stepgraph import state_tensors

    c, d, K = _cycled_clip(5)
    frame = lambda t: RGBDImages(c[:, t : t + 1], d[:, t : t + 1], K, device=cuda_device)
    slam = PointFusion(device=cuda_device)
    clear_graphs()
    states = {}
    for graphed in (False, True):
        out = [slam.init_state(frame(0), capacity=5 * 120 * 160)]
        for t in range(1, 5):
            with contextlib.nullcontext() if graphed else disable_graphs():
                out.append(slam.step_state(out[-1], frame(t)))
        states[graphed] = out
    (graph,) = slam._graphs.graphs.values()
    carry = {x.data_ptr() for x in state_tensors(graph.carry) if x is not None}
    interleaved = [slam.step_state(states[False][1], frame(2)), slam.step_state(states[False][2], frame(3))]
    for a, b in zip(states[False] + states[False][2:4], states[True] + interleaved):
        assert not carry & {x.data_ptr() for x in state_tensors(b) if x is not None}
        assert all(x is None or torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))
    clear_graphs()


@pytest.mark.parametrize("odom", ["gradicp", "gt"])
def test_icpslam_step_graphed_equals_eager(cuda_device, odom):
    """ICPSLAM.step on a bare arena through its "map" and "slam" graphs,
    twice on one instance (the second run replays both), against the same
    steps op by op: every step's arena, num_points and pose bit-equal, the
    same launches."""
    from gradslam_tpu_torch import init_map

    c, d, K = _cycled_clip(5)
    gt = np.load(DATA / "poses.npy").astype(np.float32)[:, [i % 3 for i in range(5)]]
    frames = [RGBDImages(c[:, t : t + 1], d[:, t : t + 1], K, gt[:, t : t + 1], device=cuda_device) for t in range(5)]
    slam = PointFusion(device=cuda_device, odom=odom)
    clear_graphs()
    runs = []
    for graphed in (False, True, True):
        before = (knn_kernel.launches, winner_kernel.launches)
        m, p, out = init_map(2, 5 * 120 * 160, torch.float32, device=cuda_device), None, []
        with contextlib.nullcontext() if graphed else disable_graphs():
            for f in frames:
                m, p = slam.step(m, f, p)
                out.append((m.data, m.num_points, p))
        runs.append((out, (knn_kernel.launches - before[0], winner_kernel.launches - before[1])))
    assert runs[0][1] == (0 if odom == "gt" else 4 * 40, 5)
    for out, launches in runs[1:]:
        assert launches == runs[0][1]
        for a, b in zip(out, runs[0][0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sorted(k[0] for k in slam._graphs.graphs) == (["map"] if odom == "gt" else ["map", "slam"])
    clear_graphs()


def test_clear_graphs_frees_a_graphs_buffers(cuda_device):
    """A cached sequence graph keeps its static carry and frame buffers
    allocated after its run returns; clear_graphs() frees them."""
    from gradslam_tpu_torch.slam import slam_sequence, stepgraph

    c, d, K = (torch.from_numpy(x).to(cuda_device) for x in _cycled_clip(4))
    opts = PointFusion(device=cuda_device).opts
    clear_graphs()
    slam_sequence(c, d, K, None, opts, 4 * 120 * 160)
    (graph,) = stepgraph._SEQUENCES.graphs.values()
    bufs = stepgraph.state_tensors(graph.carry) + [graph.rgb, graph.depth, graph.intrinsics]
    least = sum(t.untyped_storage().nbytes() for t in bufs if t is not None)
    del graph, bufs
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    clear_graphs()
    assert held - torch.cuda.memory_allocated() >= least


# the captured training step (GradGraph, GradStep, value_and_grad)


def _train_inputs(dev, L=3):
    """The golden clip at L frames, the depth seen by a sensor of scale
    1/1.1, the clip's poses as the target: the args of ``slam_loss`` after
    the parameters."""
    c, d, K = (torch.from_numpy(x).to(dev) for x in _cycled_clip(L))
    gt = torch.from_numpy(np.load(DATA / "poses.npy").astype(np.float32)[:, [i % 3 for i in range(L)]]).to(dev)
    return c, d / 1.1, K, gt, PointFusion(device=dev).opts, L * 120 * 160


def _counted(fn):
    before = (knn_kernel.launches, winner_kernel.launches)
    out = fn()
    return out, (knn_kernel.launches - before[0], winner_kernel.launches - before[1])


def test_training_graph_equals_the_eager_step(cuda_device):
    """value_and_grad(slam_loss) on the card: the step op by op three times,
    then through its graph (warm-up, capture, replay): the loss bit-equal,
    the gradients within four times the op-by-op spread (chip_smoke.py's
    ``_spread`` says why) and within 1e-3 of the CPU,
    a step's launches the forward's (the backward launches neither
    kernel), one cached GradGraph."""
    from gradslam_tpu_torch import value_and_grad
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss
    from gradslam_tpu_torch.slam.stepgraph import GradGraph

    vg = value_and_grad(slam_loss)
    params = DepthCalibParams(device=cuda_device)
    args = _train_inputs(cuda_device)
    assert vg.eager_reason(params, *args) is None
    clear_graphs()
    with disable_graphs():
        eager = [_counted(lambda: vg(params, *args)) for _ in range(3)]
    graphed = [_counted(lambda: vg(params, *args)) for _ in range(3)]
    (graph,) = vg.graphs.graphs.values()
    assert isinstance(graph, GradGraph) and graph.launches == {"knn": 80, "winner": 3, "mask_scan": 8,
                                                                "icp_system": 0}
    assert all(n == (80, 3) for _, n in eager + graphed)
    loss0 = eager[0][0][0]
    assert all(torch.equal(out[0], loss0) for out, _ in eager + graphed)
    grads = [torch.stack(out[1]) for out, _ in eager + graphed]
    ops = grads[:4]  # the three eager steps and the graph's warm-up
    spread = max(float((a - b).abs().max()) for i, a in enumerate(ops) for b in ops[i + 1:])
    cross = max(float((g - e).abs().max()) for g in grads[4:] for e in ops)
    assert cross <= max(4 * spread, 1e-6 * float(ops[0].abs().max())), (cross, spread)
    cpu = value_and_grad(slam_loss)(DepthCalibParams(device="cpu"), *_train_inputs(torch.device("cpu")))[1]
    cpu = torch.stack(cpu)
    assert float((grads[-1].cpu() - cpu).abs().max()) <= 1e-3 * float(cpu.abs().max())
    clear_graphs()


def test_sharded_train_step_is_one_graph_on_the_card(cuda_device):
    """sharded_train_step on make_mesh() in one process: two steps through
    one cached graph, the losses bit-equal to the same steps op by op, the
    parameters within 1e-5 relative of them; parameters kept from the first
    step unchanged by the second."""
    from gradslam_tpu_torch.parallel import DepthCalibParams, make_mesh, sharded_train_step

    c, d, K, gt, opts, cap = _train_inputs(cuda_device)
    step = sharded_train_step(make_mesh(device=cuda_device), opts, cap, lr=1e3)
    clear_graphs()
    runs = []
    for graphed in (False, True, True):
        p, out = DepthCalibParams(device=cuda_device), []
        with contextlib.nullcontext() if graphed else disable_graphs():
            for _ in range(2):
                p, loss = step(p, c, d, K, gt)
                out.append((loss, p.scale.detach().clone(), p.bias.detach().clone(), p))
        runs.append(out)
    assert len(step.train.graphs.graphs) == 1
    for out in runs[1:]:
        for (l0, s0, b0, _), (l1, s1, b1, p1) in zip(runs[0], out):
            assert torch.equal(l0, l1)
            assert float((s1 - s0).abs()) <= 1e-5 * abs(float(s0)) and float((b1 - b0).abs()) <= 1e-5
            assert torch.equal(p1.scale.detach(), s1) and torch.equal(p1.bias.detach(), b1)
    assert float(runs[0][0][1]) != 1.0
    clear_graphs()


def test_compacted_run_is_one_graph_on_the_card(cuda_device):
    """slam_sequence_compacted without grad: one captured graph of the whole
    run, compactions included, bit-equal to its eager loop in the map, the
    poses and peak_live (a 0-d device tensor), with the same launches."""
    from gradslam_tpu_torch.slam import slam_sequence_compacted, stepgraph

    c, d, K = (torch.from_numpy(x).to(cuda_device) for x in _cycled_clip(6))
    opts = PointFusion(device=cuda_device).opts
    run = lambda: slam_sequence_compacted(c, d, K, None, opts, 2 * 120 * 160, segment_len=2, voxel_size=0.005)
    clear_graphs()
    with disable_graphs():
        (m0, p0, peak0), l0 = _counted(run)
    assert l0 == (5 * 40, 6 + 2)
    for _ in range(3):
        (m, p, peak), launches = _counted(run)
        assert launches == l0 and peak.is_cuda and peak.dim() == 0 and torch.equal(peak, peak0)
        assert torch.equal(m.data, m0.data) and torch.equal(m.num_points, m0.num_points) and torch.equal(p, p0)
    (graph,) = stepgraph._SEQUENCES.graphs.values()
    assert graph.capture_s is not None
    clear_graphs()


def test_a_host_read_in_the_training_step_raises(cuda_device):
    """A training step that reads the host cannot be captured: the call
    that captures raises (nothing reruns it eagerly)."""
    from gradslam_tpu_torch import GradStep
    from gradslam_tpu_torch.parallel import DepthCalibParams, slam_loss

    args = _train_inputs(cuda_device, L=2)

    def reading(params):
        loss = slam_loss(params, *args)
        (g,) = torch.autograd.grad(loss, [params.scale])
        return g if float(loss) >= 0 else -g

    step = GradStep(reading)
    params = DepthCalibParams(device=cuda_device)
    clear_graphs()
    step(params)  # the warm-up, op by op
    with pytest.raises(Exception):
        step(params)
    clear_graphs()


def _flat(x):
    from gradslam_tpu_torch.slam.stepgraph import _tensors

    return _tensors(x)


def _closure_paths(dev):
    """Each graphed loop-closure and refinement function of
    ``slam/stepgraph.graphed`` at a small size: {name: (call, KNN launches)}."""
    from gradslam_tpu_torch.geometry import se3_exp
    from gradslam_tpu_torch.parallel import PoseGraph, ba_refine, pose_graph_refine
    from gradslam_tpu_torch.slam import (
        close_loops,
        close_loops_batched,
        close_loops_rgbd,
        detect_loop_closures,
        detect_loop_closures_descriptor,
        keyframe_descriptors,
        keyframe_descriptors_invariant,
    )

    dr, pts, nrm, val = (torch.from_numpy(x).to(dev) for x in _loop_clouds())
    with disable_graphs():
        desc = keyframe_descriptors_invariant(pts, nrm, val)
    b = lambda x: torch.stack([x, x.flip(0)])  # two trajectories: a batch of (B, 6L, 6L) solves
    c, d, K = (torch.from_numpy(x).to(dev) for x in _cycled_clip(8))
    poses = torch.from_numpy(np.load(DATA / "poses.npy").astype(np.float32)[:, [i % 3 for i in range(8)]]).to(dev)
    gen = np.random.default_rng(3)
    L = 12
    pg = se3_exp(torch.from_numpy(gen.normal(0, 0.2, (L, 6)).astype(np.float32)))
    edges = torch.tensor([(i, i + 1) for i in range(L - 1)] + [(0, L - 1)], dtype=torch.int32)
    graph = PoseGraph(pg, edges, torch.linalg.inv(pg[edges[:, 0].long()]) @ pg[edges[:, 1].long()],
                      torch.ones(edges.shape[0]))
    graph = PoseGraph(*(x.to(dev) for x in graph))
    lms = torch.from_numpy(gen.uniform([-1, -1, 2], [1, 1, 4], (100, 3)).astype(np.float32)).to(dev)
    obs_lm = torch.arange(100, device=dev).repeat_interleave(4)
    obs_pose = torch.from_numpy(gen.integers(0, L, 400)).to(dev)
    Tinv = torch.linalg.inv(graph.poses)[obs_pose]
    obs = (Tinv[:, :3, :3] @ lms[obs_lm][:, :, None])[..., 0] + Tinv[:, :3, 3]
    ba = (graph.poses, lms + 0.01, obs_pose, obs_lm, obs)
    kw = dict(max_candidates=4, min_separation=5, max_distance=0.3)
    return {
        "close_loops_batched": (lambda: close_loops_batched(b(dr), b(pts), b(nrm), b(val), descriptors=b(desc),
                                                            detection="both", **kw), 2 * (2 * 20 + 1)),
        "close_loops": (lambda: close_loops(dr, pts, nrm, val, **kw), 2 * 20 + 1),
        "close_loops_rgbd": (lambda: close_loops_rgbd(c, d, K, poses, detection="both", min_separation=2,
                                                      max_candidates=2), 2 * (2 * 20 + 1)),
        "detect_loop_closures": (lambda: detect_loop_closures(dr, **kw), 0),
        "detect_loop_closures_descriptor": (lambda: detect_loop_closures_descriptor(desc, 4, 5, 0.5), 0),
        "keyframe_descriptors_invariant": (lambda: keyframe_descriptors_invariant(pts, nrm, val), 0),
        "keyframe_descriptors": (lambda: keyframe_descriptors(d[0, ..., 0], nrm.new_ones(d[0].shape[:3] + (3,)),
                                                              d[0, ..., 0] > 0), 0),
        "pose_graph_refine": (lambda: pose_graph_refine(graph, num_iters=5), 0),
        "pose_graph_refine batched": (lambda: pose_graph_refine(PoseGraph(*(b(x) for x in graph)), num_iters=5), 0),
        "ba_refine dense": (lambda: ba_refine(*ba, num_iters=3, solver="dense"), 0),
        "ba_refine pcg": (lambda: ba_refine(*ba, num_iters=3, solver="pcg"), 0),
    }


CLOSURE_PATHS = ("close_loops_batched", "close_loops", "close_loops_rgbd", "detect_loop_closures",
                 "detect_loop_closures_descriptor", "keyframe_descriptors_invariant", "keyframe_descriptors",
                 "pose_graph_refine", "pose_graph_refine batched", "ba_refine dense", "ba_refine pcg")


@pytest.mark.parametrize("name", CLOSURE_PATHS)
def test_closure_graph_equals_the_eager_call(cuda_device, name):
    """Each loop-closure and refinement function through its captured graph
    (warm-up, capture, replays) against the same call op by op: every
    output bit-equal, the same KNN launches, one cached graph that was
    captured."""
    from gradslam_tpu_torch.slam import stepgraph

    call, knn_launches = _closure_paths(cuda_device)[name]
    clear_graphs()
    with disable_graphs():
        ref, launches = _counted(call)
    assert launches == (knn_launches, 0)
    for _ in range(4):
        out, launches = _counted(call)
        assert launches == (knn_launches, 0)
        for x, y in zip(_flat(out), _flat(ref)):
            assert x.shape == y.shape and torch.equal(x, y)
    (graph,) = stepgraph._CLOSURES.graphs.values()
    # each detector set: 20 ICP iterations of 2 KNN and 4 icp_system launches, and 1 KNN launch more
    icp_launches = knn_launches // (2 * 20 + 1) * 4 * 20
    assert graph.capture_s is not None and graph.launches == {"knn": knn_launches, "winner": 0, "mask_scan": 0,
                                                              "icp_system": icp_launches}
    clear_graphs()


def test_a_host_read_in_the_closure_raises(cuda_device):
    """A closure that reads the host cannot be captured: the call that
    captures raises (nothing reruns it eagerly), and the next call after
    ``clear_graphs()`` captures anew."""
    from gradslam_tpu_torch.slam import close_loops, loopclosure

    dr, pts, nrm, val = (torch.from_numpy(x).to(cuda_device) for x in _loop_clouds())
    call = lambda: close_loops(dr, pts, nrm, val, max_candidates=4, min_separation=5, max_distance=0.3)
    real = loopclosure.verify_loop_closures

    def reading(*args, **kwargs):
        Z, w = real(*args, **kwargs)
        return Z, w if float(w.sum()) >= 0 else -w

    clear_graphs()
    loopclosure.verify_loop_closures = reading
    try:
        call()  # the warm-up, op by op
        with pytest.raises(Exception):
            call()
    finally:
        loopclosure.verify_loop_closures = real
    clear_graphs()
    with disable_graphs():
        ref = call()
    for _ in range(3):
        out = call()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    clear_graphs()


def test_loopclosure_training_step_is_one_graph_on_the_card(cuda_device):
    """``examples_torch/train_loopclosure_ate.py``'s step (``GradStep``: the
    closure recorded inside the training graph): three steps op by op,
    then through its graph; the loss and loop weights bit-equal, the new
    log-scale within four times the op-by-op spread, 17 KNN launches a
    step (the forward's), one cached graph."""
    import importlib.util

    from gradslam_tpu_torch import GradStep
    from gradslam_tpu_torch.slam import stepgraph

    path = pathlib.Path(__file__).resolve().parents[1] / "examples_torch" / "train_loopclosure_ate.py"
    spec = importlib.util.spec_from_file_location("train_loopclosure_ate_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    problem = ex.make_problem(13, 256, 0.02, 1.15, 0, cuda_device)
    step = GradStep(ex.sgd)
    lr = torch.full((), 0.4, device=cuda_device)
    log_s = torch.zeros((), device=cuda_device)
    clear_graphs()
    with disable_graphs():
        eager = [_counted(lambda: step(log_s, lr, *problem)) for _ in range(3)]
    graphed = [_counted(lambda: step(log_s, lr, *problem)) for _ in range(3)]
    assert len(step.graphs.graphs) == 1 and not stepgraph._CLOSURES.graphs
    assert all(n == (17, 0) for _, n in eager + graphed)
    (new0, loss0, w0), _ = eager[0]
    assert all(torch.equal(out[1], loss0) and torch.equal(out[2], w0) for out, _ in eager + graphed)
    ops = [out[0] for out, _ in eager + graphed[:1]]  # the op-by-op steps and the graph's warm-up
    spread = max(float((a - b).abs()) for i, a in enumerate(ops) for b in ops[i + 1:])
    cross = max(float((out[0] - e).abs()) for out, _ in graphed[1:] for e in ops)
    assert cross <= max(4 * spread, 1e-6 * float(new0.abs())), (cross, spread)
    clear_graphs()
