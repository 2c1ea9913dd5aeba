"""The quality-tier-2 cell with the merge reorder on (`tier2-merge-respawn`)
at a tiny size on the CPU: the run is correct against the plain reference
with room to spare, the merge keeps its order on most frames and the
respawn frame falls back, a merged frame leaves the rows sorted by tile,
and the two per-layer metrics read K10 and K11 by kernel name."""

import types

import pytest
import torch

from benchmark import cell, harness, traffic
from conftest import tiny
from tendrils_tpu_torch.engine import merge_reorder_enabled
from tendrils_tpu_torch.ops import cuda_lib, draw_cuda, reorder_cuda

SEED = 2 ** 31 + 77
CELL = "tier2-merge-respawn"


def _tiny():
    """16,384 rows, the fewest that 4096-row blocks and the merge's window
    admit (the default 256 would turn the merge off unseen), on a grid of
    16 x 2 tiles, fine enough that a respawn churns past the n / 8
    capacity."""
    return tiny(CELL, root_num=128, view_res=(256, 512))


def test_the_cell_turns_the_merge_on():
    c = _tiny()
    eng = cell.make_engine(harness.program_lib(), c.config, SEED, "cpu")
    assert merge_reorder_enabled(eng.config)
    # The carry is seeded after the seed's row order: every row churns.
    assert bool((eng.sim.sort_key == reorder_cuda.MAXKEY).all())
    full = cell.load(CELL)
    assert full.config["engine"]["merge_reorder"] is True
    assert full.config["engine"]["root_num"] ** 2 == 4_194_304
    got = {m["name"] for m in full.per_layer}
    assert {"reorder_device_ms", "reorder_roofline_pct", "spawn_device_ms",
            "spawn_host_ms", "frame_ms_p95.respawn", "k2_roofline_pct",
            "launches_per_frame", "host_ms", "device_idle_pct"} <= got


def test_the_run_is_correct_and_the_merge_does_the_work():
    c = _tiny()
    result, numbers, _ = harness.run(c, SEED, 0.2, False, 0.0, device="cpu")
    assert result["correct"], result["checks"]
    assert set(c.limits) <= set(numbers)
    for name, limit in c.limits.items():
        assert numbers[name] <= limit / 10, (name, numbers[name], limit)
    # Counted from the window on: the frames that kept the merge's order,
    # and the respawn frame after it, which churned every row and fell
    # back to the flat sort.
    assert cuda_lib.events["reorder_merged"] > 0
    assert cuda_lib.events["reorder_fallback"] > 0


def test_a_merged_frame_leaves_the_rows_sorted_by_tile():
    c = _tiny()
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, SEED, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    cfg = eng.config
    n_tiles = draw_cuda.seg_tile_count(cfg.view_res)
    bits = draw_cuda._idx_bits(draw_cuda.gather_mode(
        cfg.n, n_tiles, ids=True, resident=True, idx_bound=cfg.n))
    cuda_lib.reset_counts()
    kinds = []
    for i in range(c.traffic["respawn"]["every"] + 2):
        before = dict(cuda_lib.events)
        feed.frame(i)
        kind, = (k for k, v in cuda_lib.events.items()
                 if v != before.get(k, 0))
        kinds.append(kind)
        tiles = eng.sim.sort_key >> bits
        assert bool((tiles[1:] >= tiles[:-1]).all()), (i, kind)
        assert torch.equal(eng.sim.sort_hist,
                           reorder_cuda.tile_hist(tiles, n_tiles)), i
    every = c.traffic["respawn"]["every"]
    # The seeded carry and the respawn fall back; the frames between merge.
    assert kinds[0] == kinds[every] == "reorder_fallback"
    assert set(kinds[1:every] + kinds[every + 1:]) == {"reorder_merged"}


def _view(ops, frames=10):
    return types.SimpleNamespace(
        device_ops=ops, frames=frames,
        config={"engine": {"root_num": 2048, "view_res": [1080, 1920]}})


K10 = "(anonymous namespace)::compact_kernel(int const*, int const*, int)"
K11 = "void (anonymous namespace)::apply_kernel(int const*, int*, int)"


def test_the_reorder_metrics_read_k10_and_k11_by_name():
    device_ms = cell.reader("reorder_device_ms")
    roofline = cell.reader("reorder_roofline_pct")
    others = [("void at::native::elementwise_kernel<128, 4>(int, float)",
               0.0, 500.0),
              ("(anonymous namespace)::splat_tile_kernel(Params)", 0.0, 900.0)]
    assert device_ms(_view(others)) is None
    assert roofline(_view(others)) is None
    ops = others + [(K10, 0.0, 20.0), (K11, 30.0, 75.0)] * 10
    assert device_ms(_view(ops)) == pytest.approx(0.065)
    # K10 and K11's bytes at 4,194,304 rows on the 1080 x 1920 grid's 710
    # tiles, a launch each, over 3.35 TB/s, against 65 us a frame.
    nbytes = (8 * 4_194_304 + 4 * 1024 + 12 * 524_288) \
        + (16 * 4_194_304 + 8 * 710 + 8 * 1024)
    want = 100 * nbytes / 3.35e12 / 65e-6
    assert roofline(_view(ops)) == pytest.approx(want)
    assert 0 < want <= 100
