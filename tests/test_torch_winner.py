"""gradslam_tpu_torch.ops.winner (the plain version of the per-pixel winner
kernel) against the JAX package's selection.

The JAX package picks each pixel's fusion winner with a 4-key ``lax.sort``
over ``(pix, -ccount, ray, slot)`` and keeps the first row of each pixel's
run (``gradslam_tpu/slam/fusionutils.py:904-919``, nested in
``_winner_slots``, so written out here). The port's plain version must give
the same slot per pixel exactly, on random and crafted-tie inputs; so must a
numpy oracle, and the ``pallas_rmw`` special case (``k_hi = key``,
``k_lo = 0``, ``slot = arange``) must give what ``tools/diag_winner_radix.py``
checks its kernel against (``sort4``). No tolerance: the outputs are
integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradslam_tpu_torch.ops import winner as TW

torch.set_num_threads(2)


def _jax_winner(pix, cc, ray, slot, P, sentinel):
    """The JAX package's fusion winner: 4-key sort, first of each run."""
    B = pix.shape[0]
    ps, _, _, ss = jax.vmap(
        lambda p, c, r, s: jax.lax.sort((p, -c, r, s), num_keys=4, is_stable=False)
    )(jnp.asarray(pix), jnp.asarray(cc), jnp.asarray(ray), jnp.asarray(slot))
    first = jnp.concatenate([jnp.ones((B, 1), bool), ps[:, 1:] != ps[:, :-1]], axis=1)
    win = first & (ps < P)
    bidx = jnp.broadcast_to(jnp.arange(B)[:, None], ps.shape)
    return np.asarray(
        jnp.full((B, P + 1), sentinel, jnp.int32).at[bidx, jnp.where(win, ps, P)].set(ss, mode="drop")[:, :P]
    )


def _numpy_winner(pix, cc, ray, slot, P, sentinel):
    out = np.full((pix.shape[0], P), sentinel, np.int32)
    for b in range(pix.shape[0]):
        best = {}
        for p, c, r, s in zip(pix[b], cc[b], ray[b], slot[b]):
            if 0 <= p < P:
                key = (-float(c), float(r), int(s))
                if p not in best or key < best[p]:
                    best[p] = key
        for p, key in best.items():
            out[b, p] = key[2]
    return out


def _port(pix, cc, ray, slot, P, sentinel):
    k_hi, k_lo = TW.winner_keys(torch.from_numpy(cc), torch.from_numpy(ray))
    return TW.pixel_winner(torch.from_numpy(pix), k_hi, k_lo, torch.from_numpy(slot), P, sentinel).numpy()


def _crafted_ties(rng, B, N, P):
    """Few pixels, repeating ccounts (one -0.0 against 0.0), repeating ray
    distances (with 0.0): the slot settles most pixels."""
    pix = rng.integers(0, P, (B, N)).astype(np.int32)
    pix[:, : N // 8] = P  # the 'no pixel' key past the last pixel
    cc = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32), (B, N))
    cc[0, :3] = 0.0
    ray = rng.choice(np.array([0.0, 1e-4, 2e-4, 3.0], np.float32), (B, N))
    slot = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    return pix, cc, ray, slot


@pytest.mark.parametrize("case", ["random", "ties"])
def test_plain_winner_is_the_jax_selection(case):
    rng = np.random.default_rng(0)
    B, N, P, CAP = 2, 600, 40, 5000
    if case == "random":
        pix = rng.integers(0, P + 1, (B, N)).astype(np.int32)  # P is the dump
        cc = rng.uniform(0.01, 20.0, (B, N)).astype(np.float32)
        ray = rng.uniform(0.0, 0.01, (B, N)).astype(np.float32)
        slot = rng.choice(CAP, (B, N), replace=False).astype(np.int32)
    else:
        pix, cc, ray, slot = _crafted_ties(rng, B, N, 7)
        P = 7
    got = _port(pix, cc, ray, slot, P, CAP)
    np.testing.assert_array_equal(got, _jax_winner(pix, cc, ray, slot, P, CAP))
    np.testing.assert_array_equal(got, _numpy_winner(pix, cc, ray, slot, P, CAP))
    assert (got < CAP).sum() > 0


def test_keys_at_the_ends_of_their_ranges():
    """Huge and tiny ccounts and ray distances, dump pixels beyond the last
    pixel and negative pixels: the order survives the packing, and a pixel
    outside [0, P) never wins."""
    pix = np.array([[6, 0, 0, 5, 0, -1, 9, 5]], np.int32)
    cc = np.array([[3.0, 1e30, 1e-7, 0.5, 1e30, 9e30, 9e30, 0.5]], np.float32)
    ray = np.array([[0.0, 7e4, 0.0, 1e-30, 1e-30, 0.0, 0.0, 1e-30]], np.float32)
    slot = np.array([[2_000_000, 4, 1, 7, 3, 0, 5, 6]], np.int32)
    got = _port(pix, cc, ray, slot, 6, 2**31 - 1)
    np.testing.assert_array_equal(got, [[3, 2**31 - 1, 2**31 - 1, 2**31 - 1, 2**31 - 1, 6]])
    np.testing.assert_array_equal(got, _numpy_winner(pix, cc, ray, slot, 6, 2**31 - 1))


def test_winner_keys_order_like_the_floats():
    """k_hi orders like -ccount and k_lo like ray, as unsigned words, with
    -0.0 equal to 0.0."""
    x = np.array([-3e38, -1.0, -1e-38, -0.0, 0.0, 1e-45, 1e-38, 1.0, 3e38], np.float32)
    k_hi, k_lo = TW.winner_keys(torch.from_numpy(-x), torch.from_numpy(x))
    for k in (k_hi, k_lo):
        u = k.numpy().view(np.uint32).astype(np.int64)
        assert (np.diff(u) >= 0).all() and u[3] == u[4] and (np.diff(np.delete(u, 3)) > 0).all()


def test_pallas_rmw_contract_is_the_diag_sort():
    """The diag's contract at a reduced size: random keys in [0, 2^20),
    slot = row, sentinel = N; its reference ``sort4`` is a 3-key sort
    ``(pix, key, slot)`` and the first of each run."""
    rng = np.random.default_rng(0)
    B, N, P = 2, 3000, 700
    pix = rng.integers(0, P, (B, N)).astype(np.int32)
    key = rng.integers(0, 2**20, (B, N)).astype(np.int32)
    key[:, 1::7] = key[:, ::7][:, : key[:, 1::7].shape[1]]  # exact key ties
    slot = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    got = TW.pixel_winner(
        torch.from_numpy(pix), torch.from_numpy(key), torch.zeros((B, N), dtype=torch.int32),
        torch.from_numpy(slot), P, N,
    ).numpy()
    ps, _, ss = jax.vmap(lambda a, b, c: jax.lax.sort((a, b, c), num_keys=3, is_stable=False))(
        jnp.asarray(pix), jnp.asarray(key), jnp.asarray(slot)
    )
    first = jnp.concatenate([jnp.ones((B, 1), bool), ps[:, 1:] != ps[:, :-1]], axis=1)
    bidx = jnp.broadcast_to(jnp.arange(B)[:, None], ps.shape)
    ref = np.asarray(jnp.full((B, P + 1), N, jnp.int32).at[bidx, jnp.where(first, ps, P)].set(ss)[:, :P])
    np.testing.assert_array_equal(got, ref)


def test_empty_and_dumped_candidates():
    """No candidate, or every candidate dumped: sentinel everywhere; one
    pixel receiving every candidate: the single best."""
    z = torch.zeros((2, 0), dtype=torch.int32)
    out = TW.pixel_winner(z, z, z, z, 5, 77)
    assert out.shape == (2, 5) and (out == 77).all()
    rng = np.random.default_rng(2)
    N = 500
    cc = rng.uniform(0.1, 3.0, (2, N)).astype(np.float32)
    ray = rng.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    slot = np.stack([rng.permutation(N) for _ in range(2)]).astype(np.int32)
    dumped = np.full((2, N), 5, np.int32)
    assert (_port(dumped, cc, ray, slot, 5, N) == N).all()
    one = np.full((2, N), 3, np.int32)
    got = _port(one, cc, ray, slot, 5, N)
    best = [slot[b][np.lexsort((slot[b], ray[b], -cc[b]))[0]] for b in range(2)]
    np.testing.assert_array_equal(got[:, 3], best)
    assert (np.delete(got, 3, axis=1) == N).all()


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    before = TW.winner_kernel.launches
    pix = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    k = torch.zeros_like(pix)
    out = TW.pixel_winner(pix, k, k, torch.tensor([[4, 2, 3]], dtype=torch.int32), 2, 9)
    assert out.tolist() == [[4, 2]]
    assert TW.winner_kernel.launches == before
    with pytest.raises(ValueError):
        TW.winner_kernel(pix, k, k, pix, 2, 9)  # the kernel takes CUDA tensors only


# (B, N, P) the fusion paths give the kernel, and edge cases: golden and
# ScanNet geometry (exact: N = 2*H*W; projective: the uncompacted view at
# golden, the gated buffer of 1.5*H*W at ScanNet), 480x640 with N = 2*P,
# tiny and ragged P, no candidate, one and three batch entries
GRID_SHAPES = {
    "exact golden": (2, 38_400, 19_200),
    "exact scannet": (2, 153_600, 76_800),
    "projective golden": (2, 38_400, 19_200),
    "projective scannet": (2, 115_200, 76_800),
    "480x640": (2, 614_400, 307_200),
    "P=1": (2, 5_000, 1),
    "P=7": (2, 999, 7),
    "ragged P": (2, 153_600, 76_801),
    "N=0": (2, 0, 76_800),
    "B=1": (1, 153_600, 76_800),
    "B=3 ragged": (3, 40_000, 19_999),
}


def test_winner_grid_fits_the_card_and_the_work():
    """The kernel's grid: at least one block and no more than the card holds
    at once (its launch is cooperative), at every shape and card size."""
    for B, N, P in GRID_SHAPES.values():
        for max_blocks in (1, 132, 396):
            assert 1 <= TW.winner_kernel.grid(B, N, P, max_blocks) <= max_blocks


def test_key_tables_alternate_and_are_reset():
    """Two tables a stream: each call gets a clean one of at least B * P
    entries and resets the entries of the other that the call before it
    dirtied; a larger call grows the clean one."""
    tabs = TW._Tables()
    best, other, n = tabs.take(10, "cpu")
    assert best.numel() == 10 and (best == -1).all() and n == 0 and other is best
    tabs.done(10)
    best2, other2, n2 = tabs.take(6, "cpu")
    assert best2 is not best and other2 is best and n2 == 10
    tabs.done(6)
    best3, other3, n3 = tabs.take(25, "cpu")  # grows the first table
    assert best3.numel() == 25 and (best3 == -1).all() and other3 is best2 and n3 == 6
    tabs.done(25)
    assert tabs.take(4, "cpu")[1:] == (best3, 25)
