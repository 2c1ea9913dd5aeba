"""reorder_roofline_pct: the merge reorder's kernels' least time over
their device time in the traced frames, in %.

The device time is that of `reorder_device_ms`: every launch of K10
(`compact_kernel`) and K11 (`apply_kernel`). The least time is their
bytes over the card's published 3.35 TB/s (`trace.bound_ms`), counted
from the cell's shapes as `chip_smoke.py:1908-1916` counts them (a frozen
copy), less the term that grows with the frame's churn (K11's 8 bytes a
churned row): K10 reads both i32 key streams and each 4096-row block's
first slot and writes the compacted (key, previous key, source row)
slots, 8 n + 4 nb + 12 cap; K11 reads both key streams, writes the
sorted keys and the permutation, and reads and writes the tile and block
censuses, 16 n + 8 t + 8 nb; n rows, nb = n / 4096 blocks, cap = n / 8
slots, t tiles of the padded grid (`seg_tile_count`). So the count is
the same work whatever implements it, and a lower bound of what each
launch moves. Nothing to read where neither kernel ran.
"""

from benchmark import trace
from benchmark.metrics.k2_roofline_pct import TILE_H, TILE_W, pad_dims
from benchmark.metrics.reorder_device_ms import launches

SB = 4096  # rows of a block (`tendrils_tpu_torch/ops/reorder_cuda.py:37`)


def reorder_bytes(n, grid_hw):
    """`{kernel: bytes a launch}` of K10 and K11 for `n` rows on a
    `grid_hw` grid."""
    hp, wp = pad_dims(*grid_hw)
    tiles = (hp // TILE_H) * (wp // TILE_W)
    nb, cap = n // SB, n // 8
    return {"compact_kernel": 8 * n + 4 * nb + 12 * cap,
            "apply_kernel": 16 * n + 8 * tiles + 8 * nb}


def read(view):
    ran = launches(view)
    us = sum(us for _, us in ran.values())
    if us <= 0:
        return None
    eng = view.config["engine"]
    per = reorder_bytes(eng["root_num"] ** 2, tuple(eng["view_res"]))
    nbytes = sum(per[k] * count for k, (count, _) in ran.items())
    return 100.0 * trace.bound_ms(nbytes) / (us / 1e3)
