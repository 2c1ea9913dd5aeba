"""K11's launch layout (`csrc/reorder.cu: apply_kernel`), emulated on the
CPU against `merge_apply_plain`.

The CUDA merge apply runs one 1024-thread block per 4096 rows. A U block's
thread t takes rows b x 4096 + j x 1024 + t in four passes, each pass a
block-wide exclusive scan of the U mask carried over the earlier passes;
the C blocks take sorted C rows strided by 1024. Each warp counts its
placements in their 4096-element destination blocks with one atomic when
all fall in one block, else one per block. That runs only in CUDA, so it
is transcribed here (constants and the rank expressions read from the
source) and held to the plain version's outputs and counts on a steady
frame, the engine's all-churn seed, one tile taking most of the churned
rows, and U rows out of tile order (`ok` false). The kernel itself is held
to the plain version on the card (`chip_smoke.py`).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from tendrils_tpu_torch.ops import reorder_cuda as ro

SRC = (pathlib.Path(ro.__file__).resolve().parents[1] / "csrc"
       / "reorder.cu").read_text()


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([0-9A-Z /]+?);", SRC)
    assert m, name
    return m.group(1)


SB = int(_constant("SB"))
RT = int(_constant("RT"))
PER = SB // RT
WARP = 32
N_TILES, IDX_BITS = 48, 13


def test_layout_is_the_kernels():
    """The block, pass and rank expressions transcribed below are the
    kernel's."""
    assert SB == ro.SB == 4096 and RT == 1024
    assert _constant("PER") == "SB / RT"
    flat = " ".join(SRC.split())
    for expr in ("const int r0 = b * SB + threadIdx.x;",
                 "k[j] = key[r0 + j * RT];",
                 "c_before[j] = in[j] ? csum_c_excl[t] : 0;",
                 "block_excl_scans(is_u, excl, total, sums);",
                 "int u_before = b * SB - base_b[b];",
                 "place(in[j], u_before + excl[j] + c_before[j], n, k[j], "
                 "r0 + j * RT,",
                 "u_before += total[j];",
                 "const int j0 = (blockIdx.x - nb) * SB + threadIdx.x;",
                 "const int j = j0 + i * RT;",
                 "rank[i] = in[i] ? csum_u_incl[t] + j : 0;",
                 "if (lo == hi) {"):
        assert expr in flat, expr


class Emulated:
    """apply_kernel's placements in launch order: the outputs (-1 where
    no row landed), how often each slot was written, the counts, and how
    many warps counted by the one-block rule and by grouping."""

    def __init__(self, n):
        self.n = n
        self.key = np.full(n, -1, np.int64)
        self.perm = np.full(n, -1, np.int64)
        self.writes = np.zeros(n, np.int64)
        self.counts = np.zeros(n // SB, np.int64)
        self.uniform = self.grouped = 0

    def place(self, p, rank, k, src):
        """One block's placements, `[RT]` lanes, warp by warp."""
        p = p & (rank >= 0) & (rank < self.n)
        self.key[rank[p]] = k[p]
        self.perm[rank[p]] = src[p]
        np.add.at(self.writes, rank[p], 1)
        blk = np.where(p, rank // SB, 0).reshape(-1, WARP)
        for lanes, b in zip(p.reshape(-1, WARP), blk):
            if not lanes.any():
                continue
            if b[lanes].min() == b[lanes].max():
                self.uniform += 1
                self.counts[b[lanes][0]] += lanes.sum()
            else:
                self.grouped += 1
                np.add.at(self.counts, b[lanes], 1)


def _emulate(key, prev, base_b, ck_s, src_s, k_total, csum_u_incl,
             csum_c_excl):
    key, prev, base_b, ck_s, src_s, csum_u_incl, csum_c_excl = (
        t.numpy().astype(np.int64) for t in (
            key, prev, base_b, ck_s, src_s, csum_u_incl, csum_c_excl))
    n, cap = key.size, ck_s.size
    n_tiles = csum_u_incl.size
    e = Emulated(n)
    for b in range(n // SB):
        u_before = b * SB - base_b[b]
        for j in range(PER):
            rows = b * SB + j * RT + np.arange(RT)
            is_u = key[rows] == prev[rows]
            excl = np.cumsum(is_u) - is_u
            t = key[rows] >> IDX_BITS
            ok = is_u & (t < n_tiles)
            rank = u_before + excl + csum_c_excl[np.where(ok, t, 0)]
            e.place(ok, np.where(ok, rank, 0), key[rows], rows)
            u_before += is_u.sum()
    kt = min(int(k_total), cap)
    for cb in range(-(-cap // SB)):
        for i in range(PER):
            j = cb * SB + i * RT + np.arange(RT)
            live = j < kt
            kc = np.where(live, ck_s[np.minimum(j, cap - 1)], 0)
            t = kc >> IDX_BITS
            ok = live & (t < n_tiles)
            rank = csum_u_incl[np.where(ok, t, 0)] + j
            e.place(ok, np.where(ok, rank, 0), kc,
                    src_s[np.minimum(j, cap - 1)])
    return e


def _stream(n, churn, seed, heavy=None, shuffle_blocks=False):
    """A tile-sorted previous key stream (row r's id bits r mod
    2^IDX_BITS, unique within a tile) and a frame with `churn` rows moved
    one tile (with `heavy`: into tile `heavy`); `shuffle_blocks` swaps
    the first and last 4096-row blocks of both, so U rows leave tile
    order."""
    rng = np.random.default_rng(seed)
    tiles = np.sort(rng.integers(0, N_TILES, n))
    low = np.arange(n) & ((1 << IDX_BITS) - 1)
    prev = (tiles << IDX_BITS) | low
    if heavy is None:
        cand = np.arange(n)
        new = np.clip(tiles + rng.choice([-1, 1], n), 0, N_TILES - 1)
    else:
        cand = np.flatnonzero(tiles != heavy)
        new = np.full(n, heavy)
    rows = rng.choice(cand, churn, replace=False)
    key = prev.copy()
    key[rows] = (new[rows] << IDX_BITS) | low[rows]
    hist = np.bincount(tiles, minlength=N_TILES)
    if shuffle_blocks:
        for a in (key, prev):
            a[:SB], a[-SB:] = a[-SB:].copy(), a[:SB].copy()
    return key.astype(np.int32), prev.astype(np.int32), hist.astype(np.int32)


CASES = {
    "steady": dict(n=4 * SB, churn=900),
    "all-churn seed": dict(n=4 * SB, churn=900, seed_carry=True),
    "heavy tile": dict(n=8 * SB, churn=8 * SB // 8 - 1, heavy=20),
    "U rows out of tile order": dict(n=4 * SB, churn=500,
                                     shuffle_blocks=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_layout_matches_plain(case):
    """The emulated kernel's outputs on every slot written once and its
    counts equal `merge_apply_plain`'s; where `ok` holds every slot is
    written once. The steady frame counts by the one-block rule in all
    but a few warps; the heavy tile and the out-of-order U rows need the
    grouping too."""
    spec = dict(CASES[case])
    seed_carry = spec.pop("seed_carry", False)
    key, prev, hist = _stream(spec.pop("n"), spec.pop("churn"), 3, **spec)
    if seed_carry:
        prev = np.full_like(prev, ro.MAXKEY)
        hist = np.zeros_like(hist)
    t = torch.as_tensor
    args, _ = ro.merge_plan(t(key), t(prev), t(hist), n_tiles=N_TILES,
                            idx_bits=IDX_BITS)
    want = [a.numpy() for a in ro.merge_apply_plain(*args,
                                                    idx_bits=IDX_BITS)]
    e = _emulate(*args)
    np.testing.assert_array_equal(e.counts, want[2])
    once = e.writes == 1
    np.testing.assert_array_equal(e.key[once], want[0][once])
    np.testing.assert_array_equal(e.perm[once], want[1][once])
    ok = bool(ro.merge_reorder(t(key), t(prev), t(hist), n_tiles=N_TILES,
                               idx_bits=IDX_BITS)[0])
    assert ok == (int(args[5]) <= ro.capacity(key.size)
                  and (e.counts == SB).all())
    assert ok == (case in ("steady", "heavy tile"))
    if ok:
        assert once.all()
    if case == "steady":
        assert e.grouped <= e.uniform // 20
    if case in ("heavy tile", "U rows out of tile order"):
        assert e.grouped > 0
