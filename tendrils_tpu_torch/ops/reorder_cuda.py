"""Merge reorder: restore the resident stream's tile-sorted row order
without sorting all N rows, on two hand-written CUDA kernels.

The port of `tendrils_tpu/ops/reorder_pallas.py`. The resident frame keeps
the particle rows in the order of the previous frame's sorted keys; rows
whose key did not change (U, `key == prev_key`) already form a tile-sorted
subsequence, so sortedness is restored by merging the churned rows (C)
back in:

  K10 `compact`     (csrc/reorder.cu) per 4096-row block: the C rows'
                    (key, prev_key, source row), compacted densely into a
                    buffer of capacity n // 8 with a MAXKEY fill;
  C sort            `torch.sort` of the n // 8 compacted keys (the JAX
                    package sorts them with `lax.sort` too);
  histograms        per-tile counts of the C rows' new and old tiles
                    (`tile_hist`) and their cumsums, torch ops;
  K11 `merge_apply` (csrc/reorder.cu) per row: U and sorted C rows
                    scattered to their exact merge ranks, placements
                    counted per 4096-element destination block.

Ordering contract (`reorder_pallas.py:24-30`): sorted by tile (`key >>
idx_bits`); within a tile the U rows first in their previous relative
order, then the C rows by full key. `ok` is false when the C rows exceed
the n // 8 capacity or a destination block's count is not 4096; the
caller then flat-sorts. The TPU's window guards have no counterpart in a
scatter, so `ok` may hold where the JAX's does not (ROADMAP.md queue 3).

Each kernel's wrapper takes its plain PyTorch version (`compact_plain`,
`merge_apply_plain`) when its tensors lie on the CPU and launches the
kernel when they lie on a CUDA device.
"""

import torch

from . import cuda_lib

SB = 4096         # compaction source block and apply destination block
WIN = 8192        # the smallest stream the JAX merge takes (its U window)
MAXKEY = 2 ** 31 - 1  # fill of the unused compacted slots (sorts last)

_I32 = torch.int32


def merge_eligible(n, gather):
    """Whether a stream of `n` rows in gather mode `gather` may take the
    merge: it must tile into the 4096-row blocks and its key must lead
    with the tile (modes 1 and 3). Both the engine's gate and the draw's
    call this, so they cannot drift apart."""
    return n % SB == 0 and n >= WIN and gather in (1, 3)


def capacity(n):
    """Compacted C slots of an `n`-row stream (`reorder_pallas.py:551`)."""
    return n // 8


def tile_hist(tiles, n_tiles):
    """`i32[n_tiles]` census of the integers `tiles` (values outside `[0,
    n_tiles)` dropped): the port of `hist_outer`. `torch.histc` over unit
    bins centred on the integers, exact while the bin count and every
    count stay at most 2^24 (f32 integers); not `torch.bincount`, which
    reads its input's maximum back to the host on a CUDA tensor, nor an
    `index_add_`, whose global atomics serialise on a few thousand bins."""
    return torch.histc(tiles.to(torch.float32), bins=n_tiles, min=-0.5,
                       max=n_tiles - 0.5).to(_I32)


def churn_blocks(key, prev_key):
    """Per-4096-row-block churn counts as `(k_total, base_b)`: the C row
    total (0-d) and each block's first compacted slot, the exclusive
    cumsum (`reorder_pallas.py:256-263`, XLA there too)."""
    cnt = (key != prev_key).reshape(-1, SB).sum(1, dtype=_I32)
    return cnt.sum(dtype=_I32), torch.cumsum(cnt, 0, dtype=_I32) - cnt


def _check_rows(n):
    if n % SB or n < WIN:
        raise ValueError(f"the merge takes n % {SB} == 0 and n >= {WIN}, "
                         f"got n = {n}")


def _check_stream(key, prev_key):
    n = key.shape[0]
    _check_rows(n)
    cuda_lib.check(key, "key", _I32, (n,))
    cuda_lib.check(prev_key, "prev_key", _I32, (n,))
    return n


def compact(key, prev_key, base_b):
    """K10: the rows with `key != prev_key`, in row order, as `(ck, cprev,
    csrc)` `i32[n // 8]` each: their key (MAXKEY past the last), previous
    key and source row (0 past the last). `base_b`: `churn_blocks`."""
    if cuda_lib.on_cpu(key, prev_key, base_b):
        return compact_plain(key, prev_key, base_b)
    n = _check_stream(key, prev_key)
    cuda_lib.check(base_b, "base_b", _I32, (n // SB,))
    cap = capacity(n)
    ck = torch.full((cap,), MAXKEY, dtype=_I32, device=key.device)
    cprev = torch.zeros(cap, dtype=_I32, device=key.device)
    csrc = torch.zeros(cap, dtype=_I32, device=key.device)
    cuda_lib.launch("tt_reorder_compact", "reorder_compact", key, prev_key,
                    base_b, n, cap, ck, cprev, csrc)
    return ck, cprev, csrc


def compact_plain(key, prev_key, base_b):
    """Plain version of K10: `nonzero` of the churn mask, cut to the
    capacity (`base_b` is implied by the row order)."""
    del base_b
    cuda_lib.plain_calls["reorder_compact"] += 1
    cap = capacity(key.shape[0])
    rows = (key != prev_key).nonzero()[:cap, 0]
    k = rows.shape[0]
    ck = torch.full((cap,), MAXKEY, dtype=_I32, device=key.device)
    cprev = torch.zeros(cap, dtype=_I32, device=key.device)
    csrc = torch.zeros(cap, dtype=_I32, device=key.device)
    ck[:k] = key[rows]
    cprev[:k] = prev_key[rows]
    csrc[:k] = rows.to(_I32)
    return ck, cprev, csrc


def merge_apply(key, prev_key, base_b, ck_s, src_s, k_total, csum_u_incl,
                csum_c_excl, *, idx_bits):
    """K11: every U row and the first `k_total` sorted C rows (`ck_s`,
    `src_s`: keys and source rows) placed at their merge ranks. Returns
    `(key_sorted, perm, counts)`: `i32[n]` keys and source rows in merged
    order, `i32[n // 4096]` placements per destination block. A slot no
    row reached is left unwritten (then a count is short and `ok`
    false)."""
    tensors = (key, prev_key, base_b, ck_s, src_s, k_total, csum_u_incl,
               csum_c_excl)
    if cuda_lib.on_cpu(*tensors):
        return merge_apply_plain(*tensors, idx_bits=idx_bits)
    n = _check_stream(key, prev_key)
    cap = capacity(n)
    n_tiles = csum_u_incl.shape[0]
    cuda_lib.check(base_b, "base_b", _I32, (n // SB,))
    cuda_lib.check(ck_s, "ck_s", _I32, (cap,))
    cuda_lib.check(src_s, "src_s", _I32, (cap,))
    cuda_lib.check(k_total, "k_total", _I32, ())
    cuda_lib.check(csum_u_incl, "csum_u_incl", _I32, (n_tiles,))
    cuda_lib.check(csum_c_excl, "csum_c_excl", _I32, (n_tiles,))
    key_sorted = torch.empty(n, dtype=_I32, device=key.device)
    perm = torch.empty(n, dtype=_I32, device=key.device)
    counts = torch.zeros(n // SB, dtype=_I32, device=key.device)
    cuda_lib.launch("tt_reorder_apply", "reorder_apply", key, prev_key,
                    base_b, n, ck_s, src_s, k_total, cap, csum_u_incl,
                    csum_c_excl, n_tiles, idx_bits, key_sorted, perm, counts)
    return key_sorted, perm, counts


def merge_apply_plain(key, prev_key, base_b, ck_s, src_s, k_total,
                      csum_u_incl, csum_c_excl, *, idx_bits):
    """Plain version of K11: the same rank formulas with a global `cumsum`
    of the U mask (`base_b` is implied) and one index scatter; rows that
    are not placed go to a spare slot."""
    del base_b
    cuda_lib.plain_calls["reorder_apply"] += 1
    n = key.shape[0]
    n_tiles = csum_u_incl.shape[0]
    dev = key.device
    is_u = key == prev_key
    u = is_u.to(_I32)
    t_u = key >> idx_bits
    ok_u = is_u & (t_u < n_tiles)
    rank_u = torch.cumsum(u, 0, dtype=_I32) - u \
        + csum_c_excl[torch.where(ok_u, t_u, 0)]
    j = torch.arange(ck_s.shape[0], dtype=_I32, device=dev)
    t_c = ck_s >> idx_bits
    ok_c = (j < k_total) & (t_c < n_tiles)
    rank_c = csum_u_incl[torch.where(ok_c, t_c, 0)] + j
    rank = torch.cat([rank_u, rank_c])
    placed = torch.cat([ok_u, ok_c]) & (rank >= 0) & (rank < n)
    rank = torch.where(placed, rank, n).to(torch.int64)
    key_sorted = torch.empty(n + 1, dtype=_I32, device=dev)
    perm = torch.empty(n + 1, dtype=_I32, device=dev)
    key_sorted.scatter_(0, rank, torch.cat([key, ck_s]))
    perm.scatter_(0, rank, torch.cat([torch.arange(n, dtype=_I32, device=dev),
                                      src_s]))
    counts = tile_hist(torch.where(placed, rank // SB, -1), n // SB)
    return key_sorted[:n], perm[:n], counts


def merge_plan(key, prev_key, prev_hist, *, n_tiles, idx_bits):
    """Everything the merge needs before K11: K10's compaction, the C
    rows' tile censuses and their cumsums (`reorder_pallas.py:575-592`),
    and the C sort. Returns `(apply_args, new_hist)`: `merge_apply`'s
    positional arguments and the tile census of `key`."""
    n = key.shape[0]
    _check_rows(n)
    cap = capacity(n)
    k_total, base_b = churn_blocks(key, prev_key)
    ck, cprev, csrc = compact(key, prev_key, base_b)
    valid = torch.arange(cap, dtype=_I32, device=key.device) < k_total
    hist_c = tile_hist(torch.where(valid, ck >> idx_bits, -1), n_tiles)
    hist_u = prev_hist - tile_hist(torch.where(valid, cprev >> idx_bits, -1),
                                   n_tiles)
    csum_u_incl = torch.cumsum(hist_u, 0, dtype=_I32)
    csum_c_excl = torch.cumsum(hist_c, 0, dtype=_I32) - hist_c
    ck_s, order = torch.sort(ck)  # the MAXKEY fill sorts last
    return ((key, prev_key, base_b, ck_s, csrc[order], k_total, csum_u_incl,
             csum_c_excl), hist_u + hist_c)


def merge_reorder(key, prev_key, prev_hist, *, n_tiles, idx_bits):
    """Reorder the `i32[n]` key stream `key` (n % 4096 == 0, n >= 8192)
    into tile-sorted order by merging against the previous sorted order:
    `prev_key` is the key stream the current row order is sorted by,
    `prev_hist` its `i32[n_tiles]` tile census, both carried from the
    previous frame.

    Returns `(ok, key_sorted, perm, new_hist)`: `ok` a 0-d bool device
    tensor (false: a capacity guard tripped, flat-sort this frame instead;
    the caller reads it), `perm` the source row of each output row (gather
    every other stream by it), `new_hist` the tile census of `key` (exact
    whenever `ok`)."""
    args, new_hist = merge_plan(key, prev_key, prev_hist, n_tiles=n_tiles,
                                idx_bits=idx_bits)
    key_sorted, perm, counts = merge_apply(*args, idx_bits=idx_bits)
    ok = (args[5] <= capacity(key.shape[0])) & (counts == SB).all()
    return ok, key_sorted, perm, new_hist
