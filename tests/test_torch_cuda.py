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

import pathlib

import numpy as np
import pytest
import torch

from gradslam_tpu_torch import PointFusion, RGBDImages
from gradslam_tpu_torch.ops import (
    knn,
    knn_kernel,
    knn_reference,
    pixel_winner,
    pixel_winner_reference,
    winner_keys,
    winner_kernel,
)

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
    fn = winner_kernel.load()
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
    the fusion step hands it to the kernel: bit-equal to the plain version."""
    from gradslam_tpu_torch.slam import fusionutils

    colors, depths, K = _clip()
    calls, real = [], fusionutils.pixel_winner

    def recording(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    options = {"assoc": "projective", "assoc_window": 2 * 120 * 160} if assoc == "projective" else {}
    fusionutils.pixel_winner = recording
    try:
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
