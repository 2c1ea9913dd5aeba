"""The port's merge reorder (`ops/reorder_cuda.py`: K10 `compact`, K11
`merge_apply`, their plain versions on the CPU) against the JAX package's
`reorder_pallas.merge_reorder` and `_compact` in interpret mode, on the
same seeded streams.

Where the JAX `ok` holds, the port's must too, and the merged key stream,
the source rows (the JAX's payload, the port's `perm`) and the new tile
census must match bit for bit: the keys are unique, so the ordering
contract fixes the order. The port's `ok` may hold where the JAX's does
not (the TPU's window guards have no counterpart); that is checked
against the numpy oracle of the contract instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu.ops import reorder_pallas as jro
from tendrils_tpu_torch.ops import cuda_lib, reorder_cuda as tro

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

N, N_TILES = 8192, 48


def _mk_stream(n, n_tiles, idx_bits, churn, rng, teleport=0.0):
    """A prev-sorted stream and a churned current frame, each row's low
    bits unique within its tile (a copy of tests/test_reorder.py's maker:
    mostly +-1 tile moves, some teleports, colliding keys undone)."""
    base_tiles = np.sort(rng.integers(0, n_tiles - 1, n))
    low = np.zeros(n, dtype=np.int64)
    for t in range(n_tiles):
        m = base_tiles == t
        low[m] = rng.choice(1 << idx_bits, m.sum(), replace=False)
    prev_key = (base_tiles << idx_bits) | low
    key = prev_key.copy()
    moved = rng.random(n) < churn
    delta = rng.choice([-1, 1], n)
    tele = rng.random(n) < teleport
    new_tiles = np.clip(base_tiles + delta, 0, n_tiles - 2)
    new_tiles[tele] = rng.integers(0, n_tiles - 1, int(tele.sum()))
    nk = (new_tiles << idx_bits) | low
    key[moved] = nk[moved]
    _, first = np.unique(key, return_index=True)
    dup = np.ones(n, dtype=bool)
    dup[first] = False
    key[dup] = prev_key[dup]
    prev_hist = np.bincount(prev_key >> idx_bits,
                            minlength=n_tiles).astype(np.int32)
    return key.astype(np.int32), prev_key.astype(np.int32), prev_hist


def _oracle(key, prev_key, idx_bits):
    """The contract's order: tile, then U before C, U in source order, C
    by full key (tests/test_reorder.py)."""
    is_c = (key != prev_key).astype(np.int64)
    key_eff = np.where(is_c == 1, key, 0)
    return np.lexsort((np.arange(key.size), key_eff, is_c,
                       key >> idx_bits))


def _jax(key, prev_key, prev_hist, idx_bits):
    ok, okey, (orows,), hist = jro.merge_reorder(
        jnp.asarray(key), jnp.asarray(prev_key),
        [jnp.arange(key.size, dtype=jnp.int32)], jnp.asarray(prev_hist),
        n_tiles=N_TILES, idx_bits=idx_bits, interpret=True)
    return bool(ok), np.asarray(okey), np.asarray(orows), np.asarray(hist)


def _port(key, prev_key, prev_hist, idx_bits):
    t = torch.as_tensor
    ok, okey, perm, hist = tro.merge_reorder(
        t(key), t(prev_key), t(prev_hist), n_tiles=N_TILES,
        idx_bits=idx_bits)
    return bool(ok), okey.numpy(), perm.numpy(), hist.numpy()


def _check_merge(key, prev_key, prev_hist, idx_bits):
    """Port against JAX (where the JAX merges) and both against the
    oracle; returns the port's result."""
    j_ok, j_key, j_rows, j_hist = _jax(key, prev_key, prev_hist, idx_bits)
    cuda_lib.reset_counts()
    got = _port(key, prev_key, prev_hist, idx_bits)
    assert cuda_lib.plain_calls["reorder_compact"] == 1
    assert cuda_lib.plain_calls["reorder_apply"] == 1
    ok, o_key, perm, hist = got
    if j_ok:
        assert ok
        np.testing.assert_array_equal(o_key, j_key)
        np.testing.assert_array_equal(perm, j_rows)
        np.testing.assert_array_equal(hist, j_hist)
    if ok:
        order = _oracle(key, prev_key, idx_bits)
        np.testing.assert_array_equal(perm, order)
        np.testing.assert_array_equal(o_key, key[order])
        np.testing.assert_array_equal(
            hist, np.bincount(key >> idx_bits, minlength=N_TILES))
    return got


@pytest.mark.parametrize("idx_bits", [13, 19])
@pytest.mark.parametrize("churn,teleport", [(0.0, 0.0), (0.06, 0.0),
                                            (0.10, 0.3)],
                         ids=["still", "churn6", "churn10-teleport"])
def test_merge_reorder_matches_jax(churn, teleport, idx_bits):
    rng = np.random.default_rng(3)
    key, prev_key, prev_hist = _mk_stream(N, N_TILES, idx_bits, churn, rng,
                                          teleport)
    ok, *_ = _check_merge(key, prev_key, prev_hist, idx_bits)
    assert ok


def test_merge_reorder_chained_frames():
    """Three frames, each one's output order and census the next one's
    carry; the rows' identities followed through."""
    rng = np.random.default_rng(11)
    idx_bits = 13
    key, prev_key, prev_hist = _mk_stream(N, N_TILES, idx_bits, 0.08, rng)
    ids = np.arange(N)
    for _ in range(3):
        ok, o_key, perm, hist = _check_merge(key, prev_key, prev_hist,
                                             idx_bits)
        assert ok
        ids = ids[perm]
        prev_key, prev_hist = o_key, hist
        key = prev_key.copy()
        moved = rng.random(N) < 0.07
        tiles = np.clip((prev_key[moved] >> idx_bits)
                        + rng.choice([-1, 1], moved.sum()), 0, N_TILES - 2)
        key[moved] = (tiles << idx_bits) | (prev_key[moved]
                                            & ((1 << idx_bits) - 1))
        _, first = np.unique(key, return_index=True)
        dup = np.ones(N, dtype=bool)
        dup[first] = False
        key[dup] = prev_key[dup]
    np.testing.assert_array_equal(np.sort(ids), np.arange(N))


@pytest.mark.parametrize("seeded", [False, True], ids=["churn90", "seed"])
def test_merge_reorder_over_capacity_falls_back(seeded):
    """Churn beyond the n // 8 capacity (a mass respawn; the engine's
    all-MAXKEY seed) gives `ok` false on both sides."""
    rng = np.random.default_rng(5)
    key, prev_key, prev_hist = _mk_stream(N, N_TILES, 13, 0.9, rng,
                                          teleport=0.5)
    if seeded:
        prev_key = np.full(N, tro.MAXKEY, np.int32)
        prev_hist = np.zeros(N_TILES, np.int32)
    assert (key != prev_key).sum() > tro.capacity(N)
    j_ok = _jax(key, prev_key, prev_hist, 13)[0]
    ok = _port(key, prev_key, prev_hist, 13)[0]
    assert not j_ok and not ok


@pytest.mark.parametrize("churn", [0.06, 0.10])
def test_compact_matches_jax(churn):
    """K10's plain version: the valid compacted entries (key != MAXKEY, in
    order) equal the JAX's ragged-128 output; the fill past them."""
    rng = np.random.default_rng(7)
    key, prev_key, _ = _mk_stream(N, N_TILES, 13, churn, rng, 0.2)
    lanes = jro.LANES
    k_rag_rows = max(N // 8 // lanes + N // jro.SB + jro.SB // lanes,
                     jro.CWIN // lanes)
    ck2, cprev2, (csrc2,), k_total, ok_layout = jro._compact(
        jnp.asarray(key).reshape(-1, lanes),
        jnp.asarray(prev_key).reshape(-1, lanes),
        [jnp.arange(N, dtype=jnp.int32).reshape(-1, lanes)], k_rag_rows,
        True)
    ckj = np.asarray(ck2).ravel()
    valid = ckj != jro.MAXKEY
    t = torch.as_tensor
    k_tot, base_b = tro.churn_blocks(t(key), t(prev_key))
    ck, cprev, csrc = tro.compact(t(key), t(prev_key), base_b)
    k = int(k_tot)
    assert k == int(k_total) == valid.sum() and bool(ok_layout)
    np.testing.assert_array_equal(ck[:k].numpy(), ckj[valid])
    np.testing.assert_array_equal(cprev[:k].numpy(),
                                  np.asarray(cprev2).ravel()[valid])
    np.testing.assert_array_equal(csrc[:k].numpy(),
                                  np.asarray(csrc2).ravel()[valid])
    assert (ck[k:] == tro.MAXKEY).all()
    churned = np.flatnonzero(key != prev_key)
    np.testing.assert_array_equal(csrc[:k].numpy(), churned)
    # Block bases: each block's first compacted slot.
    cnt = (key != prev_key).reshape(-1, tro.SB).sum(1)
    np.testing.assert_array_equal(base_b.numpy(), np.cumsum(cnt) - cnt)


def test_tile_hist_drops_out_of_range():
    tiles = torch.tensor([0, 3, 3, -1, 5, 7, 2], dtype=torch.int32)
    np.testing.assert_array_equal(tro.tile_hist(tiles, 5).numpy(),
                                  [1, 0, 1, 2, 0])


def test_merge_eligible_gate():
    """The one gate the engine and the draw share
    (`draw_pallas.py:1244-1247`, `engine.py:149-150`)."""
    assert tro.merge_eligible(8192, 1) and tro.merge_eligible(1 << 24, 3)
    assert not tro.merge_eligible(4096, 1)
    assert not tro.merge_eligible(8192 + 2048, 1)
    assert not tro.merge_eligible(1 << 22, 2)
    assert not tro.merge_eligible(1 << 20, 0)
