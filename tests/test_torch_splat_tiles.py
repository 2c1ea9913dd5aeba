"""K2's tile partition against the JAX reference's key and region rule and
against the plain splat.

The CUDA tile pass (`csrc/splat.cu`) owns one output tile a block and adds
there the samples that fit their key tile's region; the stray pass adds
the rest. Its contract is the reference's (`draw_pallas.py:82-85`,
`:255-263`, `:347-353`): the key's tile is the top-left corner of the
segment's bounding box, and a sample fits when its footprint lies inside
that tile's REGION_H x REGION_W region. Each case packs one seeded stream
with the port's K1 (plain) and with the JAX `_pack_core` (eager), sorts it
(flat, or by the merge reorder), and checks the partition on it; then the
deposits of both passes, part by part, sum to `splat_plain`.

The grid's tiles and the queue's room are the wrapper's own code. The
tile ranges (`tile_start`), the part cut (`tile_body`) and the fit test
(`fits_key_tile`) run only in CUDA: below they are transcribed into
Python, and only their constants are read from the CUDA source. So these
tests hold the partition's design to the reference; that the kernels
follow it is checked on the card, where `chip_smoke.py` holds the plan's
tile ranges to `torch.searchsorted` and K2 to `splat_plain` on streams
with split tiles and strays.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tendrils_tpu.ops import draw_pallas as jdraw
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.ops import draw_cuda as tdraw, reorder_cuda
from tendrils_tpu_torch.ops.tile_geom import (HALF, REGION_H, REGION_W,
                                              TILE_H, TILE_W, pad_dims)

CSRC = pathlib.Path(tdraw.__file__).resolve().parents[1] / "csrc"
GRID = (64, 384)
SPEED_LIMIT = 0.03
TIME = 160.0
SAMPLES = 2
# (case, gather mode, exact p0 stream, rows)
CASES = [("gather0", 0, True, 2048), ("gather1", 1, False, 2048),
         ("gather2", 2, True, 2048), ("gather3", 3, False, 2048),
         ("merge", 1, False, 8192), ("dead", 1, False, 2048),
         ("edge", 0, True, 2048), ("long", 2, True, 2048)]
IDS = [c[0] for c in CASES]


# --- the CUDA partition, transcribed --------------------------------------

def _tile_starts(keym_s, bits, n_tiles):
    """First row of each tile, and the end, in the tile-sorted keys: `i32
    [n_tiles + 1]` (the plan's `tile_start`, the tile read from the sorted
    key itself)."""
    tiles = torch.arange(n_tiles + 1, dtype=torch.int32)
    return torch.searchsorted(keym_s >> bits, tiles, out_int32=True)


def _source_runs(starts, tile, tiles_x):
    """The rows whose segments can deposit into output tile `tile`: the
    runs `(start, end)` of its source tiles above-left, above, left and
    itself, in the order the tile pass lays them end to end (empty past
    the grid's edges; `splat_plan_kernel`)."""
    ty, tx = divmod(tile, tiles_x)
    return [(0, 0) if sy < 0 or sx < 0 else
            (int(starts[sy * tiles_x + sx]), int(starts[sy * tiles_x + sx + 1]))
            for sy in (ty - 1, ty) for sx in (tx - 1, tx)]


def _tile_parts(runs, chunk):
    """`(rows, parts)` of an output tile's source runs: every source row
    counts alike (`splat_plan_kernel`)."""
    w = sum(b - a for a, b in runs)
    return w, (-(-w // chunk) if w > chunk else 1)


def _part_rows(runs, j, parts):
    """`(lo, hi)`: the rows of part j of `parts`, as indices into the
    source runs laid end to end, cut into equal counts (`tile_body`)."""
    w = _tile_parts(runs, 1)[0]
    return w * j // parts, w * (j + 1) // parts


def _tile_rows(starts, tiles_y, tiles_x):
    """Source rows of each output tile: `[tiles_y, tiles_x]`."""
    rows = torch.diff(starts).to(torch.int64)
    p = F.pad(rows.reshape(tiles_y, tiles_x), (1, 0, 1, 0))
    return p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]


def _sample_fits(tile, gx, gy, scal, tiles_x):
    """Whether each sample's footprint (half the wider box width around
    the quantised centre `gx, gy`) lies inside the region of key tile
    `tile` (`fits_key_tile`): the reference's upper bound
    (`draw_pallas.py:350-351`) and its lower one, which the key makes true
    but for the margin clamp; at the grid's top and left edges the region
    reaches out past them (texels there do not exist)."""
    hwm = torch.maximum(torch.clamp(scal[2], 1.0, tdraw.KMAX_WIDTH),
                        torch.clamp(scal[3], 1.0, tdraw.KMAX_WIDTH)) * 0.5
    ty = tile // tiles_x
    row0 = (ty * TILE_H).to(torch.float32)
    col0 = ((tile - ty * tiles_x) * TILE_W).to(torch.float32)
    return (((gy + (0.5 - hwm) >= row0) | (row0 == 0))
            & (gy + (0.5 + hwm) <= row0 + REGION_H)
            & ((gx + (0.5 - hwm) >= col0) | (col0 == 0))
            & (gx + (0.5 + hwm) <= col0 + REGION_W))


def _fits(scal, keym_s, p1, vl, *, bits, **kw):
    """`(fits, live, groups)`: which samples `bool[S, N]` of the sorted
    stream fit their key tile's region, which carry mass in a channel
    group of the launch (the others add nothing in either pass; a group's
    alpha is its channel before the log), and their deposit terms
    (`_splat_terms`)."""
    gx, gy, groups = tdraw._splat_terms(scal, p1, vl, **kw)
    fits = _sample_fits((keym_s >> bits)[None], gx, gy, scal,
                        tdraw.splat_tiles(GRID)[1])
    live = torch.stack([chans[-2] > 0 for chans, *_ in groups]).any(dim=0)
    return fits, live, groups


def _select(groups, rows, keep):
    """The deposit terms of segments `rows`, zeroed where not `keep`."""
    k = keep[:, rows]
    return [(chans[..., rows] * k, ch0, inv_w,
             tuple(t[:, rows] for t in ys), tuple(t[:, rows] for t in xs))
            for chans, ch0, inv_w, ys, xs in groups]


def _tile_mirror(scal, keym_s, p1, vl, *, bits, chunk, **kw):
    """K2's two passes in Python, block for block: `(tiles, strays)`, the
    padded accumulators of the tile pass (each output tile adds the
    fitting samples of its source runs, part by part, into its own texels)
    and of the stray pass (the samples that do not fit)."""
    hp, wp = pad_dims(*GRID)
    tiles_y, tiles_x = tdraw.splat_tiles(GRID)
    fits, _, groups = _fits(scal, keym_s, p1, vl, bits=bits, **kw)
    starts = _tile_starts(keym_s, bits, tiles_y * tiles_x)
    planes = tdraw.N_CHAN - tdraw.first_channel(kw.get("flow_off", False))
    size = planes * hp * wp
    tiles = torch.zeros(planes, hp, wp)
    for t in range(tiles_y * tiles_x):
        runs = _source_runs(starts, t, tiles_x)
        rows = torch.cat([torch.arange(a, b) for a, b in runs])
        ty, tx = divmod(t, tiles_x)
        win = (slice(None), slice(ty * TILE_H, (ty + 1) * TILE_H),
               slice(tx * TILE_W, (tx + 1) * TILE_W))
        parts = _tile_parts(runs, chunk)[1]
        for j in range(parts):
            lo, hi = _part_rows(runs, j, parts)
            if hi > lo:
                part = tdraw._add_boxes(
                    torch.zeros(size), _select(groups, rows[lo:hi], fits),
                    hp, wp).reshape(tiles.shape)
                tiles[win] += part[win]
    strays = tdraw._add_boxes(
        torch.zeros(size), _select(groups, torch.arange(p1.shape[0]), ~fits),
        hp, wp)
    return tiles, strays.reshape(tiles.shape)


def test_transcription_constants_are_the_kernels():
    """The transcription's part cut (every source row alike), the plan's
    word counts and the region are `csrc/`'s, and the queue has room for
    every part they cut."""
    src = (CSRC / "splat.cu").read_text()
    assert re.search(r"const int w = \(a1 - a0\) \+ \(b1 - b0\);", src)
    assert re.search(r"const int lo = \(int\)\(w \* part / parts\);", src)
    assert re.search(rf"INFO = {tdraw.SPLAT_INFO};", src)
    assert re.search(rf"QUEUE_HEAD = {tdraw.SPLAT_QUEUE_HEAD};", src)
    common = (CSRC / "common.cuh").read_text()
    assert re.search(rf"REGION_H = {REGION_H};", common)
    assert re.search(rf"REGION_W = {REGION_W};", common)
    for n, grid in ((2048, GRID), (1 << 20, (1080, 1920)),
                    (1 << 22, (1080, 1920)), (1 << 24, (2160, 3840))):
        tiles_y, tiles_x = tdraw.splat_tiles(grid)
        chunk = tdraw.split_chunk(n, tiles_y * tiles_x)
        # A split tile of w source rows has ceil(w / chunk) <= 2 w / chunk
        # parts, and each row is a source of 4 tiles.
        assert tdraw.queue_cap(n, chunk) >= 2 * 4 * n / chunk


def _inputs(case, n, rng):
    """A draw's inputs in window px: positions a little beyond the view,
    velocities within the speed limit, a tenth of the rows dead; "dead":
    a half; "edge": a fifth far past the edges (p1 clamped into the
    margin); "long": a tenth with p0 anywhere on the grid."""
    h, w = GRID
    vs = np.float32(max(h, w)) / np.asarray([w, h], np.float32)
    pos = (rng.uniform(-1.02, 1.02, (2, n)) / vs[:, None]).astype(np.float32)
    if case == "edge":
        far = rng.random(n) < 0.2
        pos[:, far] = (rng.uniform(-1.6, 1.6, (2, int(far.sum())))
                       / vs[:, None])
    vel = (rng.uniform(-0.7, 0.7, (2, n)) * SPEED_LIMIT).astype(np.float32)
    dead = rng.random(n) < (0.5 if case == "dead" else 0.1)
    pos[:, dead] = INERT
    vel[:, dead] = 0.0
    p1 = np.stack([(pos[0] * vs[0] * np.float32(0.5) + np.float32(0.5)) * w,
                   (pos[1] * vs[1] * np.float32(0.5) + np.float32(0.5)) * h],
                  axis=-1).astype(np.float32)
    p0 = (p1 - vel.T * vs * np.float32(0.5)
          * np.asarray([w, h], np.float32)).astype(np.float32)
    if case == "long":
        jump = rng.random(n) < 0.1
        p0[jump] = rng.uniform(0, 1, (int(jump.sum()), 2)) * [w, h]
    return dict(p0=p0, p1=p1, vel=vel, pos=pos,
                live=(~dead).astype(np.float32),
                idx=rng.permutation(n).astype(np.int32), vs=vs)


def _scal(c, exact_p0):
    """`f32[32]` draw scalars (flowWidth 5, lineWidth 1; slots 30/31 the
    view size only when the splat re-derives p0, as the draw builds them)."""
    s = np.zeros(32, np.float32)
    s[:7] = [SPEED_LIMIT, TIME, 5.0, 1.0, 1e-6, 0.3, 0.005]
    s[7:11] = [1.0, 1.0, 1.0, 0.5]
    s[11:15] = [1.0, 1.0, 1.0, 0.04]
    s[16:20] = np.float32([0.2, 0.5, 0.8, 1.0]) * np.float32(0.4)
    if not exact_p0:
        s[30:32] = c["vs"]
    return s


def _port_pack(c, scal, gather, exact_p0):
    t = torch.as_tensor
    return tdraw.pack_plain(
        t(scal), t(c["p1"]), t(c["vel"]), t(c["live"]),
        t(c["idx"]) if gather else None, grid_hw=GRID,
        pscale=tdraw.pos_scale_for(GRID),
        p0_pix=t(c["p0"]) if exact_p0 else None, gather=gather)


def _jax_keys(c, scal, gather, exact_p0):
    """The JAX `_pack_core`'s sort keys (eager, numpy output refs)."""
    h, w = GRID
    hp, wp = pad_dims(h, w)
    n = c["idx"].size
    out = {k: np.zeros(n, np.int32) for k in ("keym", "p0", "p1", "vl")}
    grefs = [np.zeros(n, np.int32)] if gather == 2 else []
    j = jnp.asarray
    zeros = j(np.zeros(n, np.float32))
    with jax.disable_jit():
        jdraw._pack_core(
            scal[None], j(c["p0"][:, 0]), j(c["p0"][:, 1]), j(c["p1"][:, 0]),
            j(c["p1"][:, 1]), j(c["vel"][0]), j(c["vel"][1]), zeros, zeros,
            zeros, zeros, zeros, zeros, j(c["live"]), j(c["idx"]),
            out["keym"], out["p0"] if exact_p0 else None, out["p1"],
            out["vl"], None, grefs, tiles_x=wp // TILE_W,
            pscale=jdraw._pos_scale(hp, wp), h=h, w=w, gather=gather,
            emit_rgba=False, key_recon=not exact_p0)
    return out["keym"]


def _jax_region_rule(scal, p1, vl, p0):
    """The reference kernel's own key and fit rule on sorted words
    (`draw_pallas.py:221-263`, `:340-353`, transcribed in jnp): per row the
    re-derived segment key tile, per sample the quantised centre and
    whether its footprint's bottom-right stays in the key tile's region.
    Returns `(seg_key [N], fits [S, N], gyq [S, N], gxq [S, N], seg_row,
    seg_col)`."""
    h, w = GRID
    hp, wp = pad_dims(h, w)
    tiles_x = wp // TILE_W
    pscale = jdraw._pos_scale(hp, wp)
    inv_p = 1.0 / pscale
    j = jnp.asarray
    scal, p1, vl = j(scal), j(p1), j(vl)
    speed_limit = scal[0]
    hwm = jnp.maximum(jnp.clip(scal[2], 1.0, 8.0),
                      jnp.clip(scal[3], 1.0, 8.0)) * 0.5
    p1x = (p1 & HALF).astype(jnp.float32) * inv_p
    p1y = (p1 >> 15).astype(jnp.float32) * inv_p
    vel_u = vl & (2 ** 30 - 1)

    def unq(q):
        return q.astype(jnp.float32) * (2.0 / HALF) - 1.0

    vx = unq(vel_u & HALF) * speed_limit
    vy = unq(vel_u >> 15) * speed_limit
    if p0 is None:
        p0x = jnp.clip(p1x - vx * (scal[30] * 0.5 * w), 1.0,
                       jdraw.PAD_LO_W + w + 1.0)
        p0y = jnp.clip(p1y - vy * (scal[31] * 0.5 * h), 1.0,
                       jdraw.PAD_LO_H + h + 1.0)
    else:
        p0 = j(p0)
        p0x = (p0 & HALF).astype(jnp.float32) * inv_p
        p0y = (p0 >> 15).astype(jnp.float32) * inv_p
    dx, dy = p1x - p0x, p1y - p0y
    seg_top_x = jnp.maximum(jnp.minimum(p0x, p1x) - hwm, 0.0)
    seg_top_y = jnp.maximum(jnp.minimum(p0y, p1y) - hwm, 0.0)
    seg_row = jnp.floor(seg_top_y).astype(jnp.int32) // TILE_H
    seg_col = jnp.floor(seg_top_x).astype(jnp.int32) // TILE_W
    reg_y_hi = (seg_row * TILE_H).astype(jnp.float32) + REGION_H
    reg_x_hi = (seg_col * TILE_W).astype(jnp.float32) + REGION_W
    fits, gys, gxs = [], [], []
    for s in range(SAMPLES):
        ts = (s + 0.5) / SAMPLES
        xp = jnp.clip(p0x + dx * ts, 1.0, jdraw.PAD_LO_W + w + 1.0)
        yp = jnp.clip(p0y + dy * ts, 1.0, jdraw.PAD_LO_H + h + 1.0)
        gxq = jnp.round(xp * pscale).astype(jnp.int32).astype(
            jnp.float32) * inv_p - 0.5
        gyq = jnp.round(yp * pscale).astype(jnp.int32).astype(
            jnp.float32) * inv_p - 0.5
        fits.append((gyq + 0.5 + hwm <= reg_y_hi)
                    & (gxq + 0.5 + hwm <= reg_x_hi))
        gys.append(gyq)
        gxs.append(gxq)
    return tuple(np.asarray(a) for a in (
        seg_row * tiles_x + seg_col, jnp.stack(fits), jnp.stack(gys),
        jnp.stack(gxs), seg_row, seg_col)) + (float(hwm),)


def _sorted_case(case, gather, exact_p0, n):
    """Pack one case with the port and the JAX package (keys bit for bit)
    and sort it: flat, or ("merge") by the merge reorder against the
    previous frame's sorted order. Returns the scalars, the sorted words
    `(keym, p1, vl, p0 or None)` and the id bits."""
    rng = np.random.default_rng(IDS.index(case))
    c = _inputs(case, n, rng)
    scal = _scal(c, exact_p0)
    words = _port_pack(c, scal, gather, exact_p0)
    np.testing.assert_array_equal(words[0].numpy(),
                                  _jax_keys(c, scal, gather, exact_p0))
    bits = tdraw._idx_bits(gather)
    keym_s, perm = torch.sort(words[0])
    if case == "merge":
        # The next frame of the sorted rows, each moved by its velocity.
        nt = tdraw.seg_tile_count(GRID)
        hist = reorder_cuda.tile_hist(keym_s >> bits, nt)
        order = perm.numpy()
        nxt = {k: c[k][order] for k in ("p0", "p1", "live", "idx")}
        nxt.update(vel=c["vel"][:, order], vs=c["vs"], pos=c["pos"])
        step = nxt["vel"].T * c["vs"] * np.float32(0.5) \
            * np.asarray(GRID[::-1], np.float32)
        nxt["p1"] = (nxt["p1"] + 0.5 * step).astype(np.float32)
        c = nxt
        words = _port_pack(c, scal, gather, exact_p0)
        np.testing.assert_array_equal(words[0].numpy(),
                                      _jax_keys(c, scal, gather, exact_p0))
        assert reorder_cuda.merge_eligible(n, gather)
        churned = (words[0] != keym_s).sum().item()
        assert 0 < churned <= n // 8
        ok, keym_s, perm, _ = reorder_cuda.merge_reorder(
            words[0], keym_s, hist, n_tiles=nt, idx_bits=bits)
        assert bool(ok)
    sorted_words = [None if a is None else a[perm] for a in words[:4]]
    sorted_words[0] = keym_s
    return torch.as_tensor(scal), sorted_words, bits


@pytest.mark.parametrize("case,gather,exact_p0,n", CASES, ids=IDS)
def test_partition_matches_reference_rule(case, gather, exact_p0, n):
    """The tile of each sorted key is the reference's re-derived segment
    key; the fit test is the reference's region test (its upper bound)
    and the lower bound of the region (but at the grid's top and left
    edges); the plan's tile starts give each output tile exactly the
    rows whose key tile is one of its sources, in order, and the part cut
    makes consecutive parts whose count the queue has room for; long
    segments become strays, samples clamped onto the top or left margin
    do not, dead rows carry no mass."""
    scal, (keym_s, p1, vl, p0), bits = _sorted_case(case, gather, exact_p0,
                                                    n)
    tiles_y, tiles_x = tdraw.splat_tiles(GRID)
    assert (tiles_y, tiles_x) == (7, 4)
    tile = (keym_s >> bits).numpy()
    assert (np.diff(tile) >= 0).all()  # tile-sorted
    if case == "merge":
        assert (np.diff(keym_s.numpy()) < 0).any()  # not the flat order
    seg_key, ref_fits, gyq, gxq, seg_row, seg_col, hwm = _jax_region_rule(
        scal.numpy(), p1.numpy(), vl.numpy(),
        None if p0 is None else p0.numpy())
    np.testing.assert_array_equal(tile, seg_key)
    kw = dict(samples=SAMPLES, grid_hw=GRID,
              pscale=tdraw.pos_scale_for(GRID), p0=p0)
    fits, live, _ = _fits(scal, keym_s, p1, vl, bits=bits, **kw)
    lower = ((gyq + (0.5 - hwm) >= seg_row * TILE_H) | (seg_row == 0)) \
        & ((gxq + (0.5 - hwm) >= seg_col * TILE_W) | (seg_col == 0))
    np.testing.assert_array_equal(fits.numpy(), ref_fits & lower)

    starts = _tile_starts(keym_s, bits, tiles_y * tiles_x)
    assert starts.dtype == torch.int32
    assert starts[0] == 0 and starts[-1] == n
    tile_rows = _tile_rows(starts, tiles_y, tiles_x)
    queued = 0
    for t in range(tiles_y * tiles_x):
        runs = _source_runs(starts, t, tiles_x)
        rows = np.concatenate([np.arange(a, b) for a, b in runs])
        ty, tx = divmod(t, tiles_x)
        want = np.flatnonzero(np.isin(tile // tiles_x, (ty - 1, ty))
                              & np.isin(tile % tiles_x, (tx - 1, tx)))
        np.testing.assert_array_equal(rows, want)
        # The runs in order: above-left, above, left, the tile itself.
        for (a, b), (sy, sx) in zip(runs, ((ty - 1, tx - 1), (ty - 1, tx),
                                           (ty, tx - 1), (ty, tx))):
            assert ((tile[a:b] // tiles_x == sy)
                    & (tile[a:b] % tiles_x == sx)).all()
        count, parts = _tile_parts(runs, 64)
        assert tile_rows[ty, tx] == count
        queued += parts if parts > 1 else 0
        # The parts cut the runs laid end to end into consecutive pieces
        # of at most the chunk's rows.
        bounds = [_part_rows(runs, j, parts) for j in range(parts)]
        assert bounds[0][0] == 0 and bounds[-1][1] == rows.size
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert parts == 1 or count > 64
        assert max(b - a for a, b in bounds) <= 64
    assert queued <= tdraw.queue_cap(n, 64)

    strays = (live & ~fits).sum().item()
    dead = (vl.numpy() >> 30) == 0
    assert not live.numpy()[:, dead].any()
    assert live.sum().item() > 0
    if case == "long":
        assert strays > 0
    if case == "edge":
        # Boxes clamped onto the top or left margin reach past the grid's
        # edge; they fit their edge tile's region (texels past the edge do
        # not exist in either pass).
        past = live.numpy() & ((gyq + (0.5 - hwm) < 0)
                               | (gxq + (0.5 - hwm) < 0))
        assert past.any() and fits.numpy()[past].all()


@pytest.mark.parametrize("case,gather,exact_p0,n", CASES, ids=IDS)
def test_tile_mirror_sums_to_plain(case, gather, exact_p0, n):
    """The tile pass's deposits (each output tile adding the fitting
    samples of its source runs into its own texels, split into parts of
    at most 128 source rows) plus the stray pass's sum to `splat_plain`
    within 1e-6 of each channel's max; the stray pass adds only what the
    tile pass leaves."""
    scal, (keym_s, p1, vl, p0), bits = _sorted_case(case, gather, exact_p0,
                                                    n)
    rng = np.random.default_rng(7)
    rgba = None if p0 is None and case != "gather3" else torch.as_tensor(
        rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32)
        & 0x7fffffff)
    kw = dict(samples=SAMPLES, grid_hw=GRID,
              pscale=tdraw.pos_scale_for(GRID), p0=p0, rgba=rgba)
    tiles, strays = _tile_mirror(scal, keym_s, p1, vl, bits=bits,
                                 chunk=128, **kw)
    want = tdraw.splat_plain(scal, p1, vl, **kw)
    # The wrapper on CPU tensors is the plain version.
    got = tdraw.splat(scal, keym_s, p1, vl, idx_bits=bits, **kw)
    assert torch.equal(got, want)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1)
    assert (scale > 0).all()
    err = (tiles + strays - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    assert (err <= 1e-6 * scale).all(), (err, scale)
    fits, live, _ = _fits(scal, keym_s, p1, vl, bits=bits, **kw)
    assert (strays.abs().sum() > 0) == bool((live & ~fits).any())


# --- the view-only launch (flow_off) -----------------------------------------


def _launch_groups(ch0):
    """The tile pass's channel groups for a scratch from global channel
    `ch0`, transcribed from `splat.cu` (the grid's y extent,
    `channel_groups`, and the group each `blockIdx.y` runs): `[(group,
    first scratch plane)]`, group 0 the flow's, 1 the view's."""
    src = (CSRC / "splat.cu").read_text()
    assert "return ch0 == 0 ? 2 : 1;" in src
    assert re.search(r"const dim3 grid\(queue_cap \+ \(hp / TILE_H\) \* "
                     r"\(wp / TILE_W\),\s+channel_groups\(ch0\)\);", src)
    assert "const int group = (int)blockIdx.y + 2 - channel_groups(P.ch0);" \
        in src
    assert "fix + (N_FLOW - P.ch0) * (long long)P.hp * P.wp);" in src
    n_groups = 2 if ch0 == 0 else 1
    groups = [y + 2 - n_groups for y in range(n_groups)]
    return [(g, 0 if g == 0 else tdraw.N_FLOW - ch0) for g in groups]


def test_view_only_launch_is_one_group():
    """The 11-channel launch runs both groups (the view's at plane 5), the
    view-only one the view's alone at plane 0: the planes the plain
    splat's groups fill."""
    assert _launch_groups(0) == [(0, 0), (1, tdraw.N_FLOW)]
    assert _launch_groups(tdraw.first_channel(True)) == [(1, 0)]
    scal, (keym_s, p1, vl, p0), _ = _sorted_case("gather1", 1, False, 2048)
    kw = dict(samples=SAMPLES, grid_hw=GRID, pscale=tdraw.pos_scale_for(GRID),
              p0=p0)
    for flow_off in (False, True):
        groups = tdraw._splat_terms(scal, p1, vl, flow_off=flow_off, **kw)[2]
        launch = _launch_groups(tdraw.first_channel(flow_off))
        assert [g[1] for g in groups] == [plane for _, plane in launch]
        assert [len(g[0]) for g in groups] == [
            (tdraw.N_FLOW, tdraw.N_VIEW)[group] for group, _ in launch]


VIEW_CASES = [c for c in CASES if c[0] in ("gather0", "gather1", "merge",
                                           "long")]


@pytest.mark.parametrize("case,gather,exact_p0,n", VIEW_CASES,
                         ids=[c[0] for c in VIEW_CASES])
def test_view_only_tile_mirror_sums_to_plain(case, gather, exact_p0, n):
    """The view-only launch's tile pass (one group, six planes) plus its
    stray pass sum to the view-only `splat_plain` within 1e-6 of each
    channel's max, which is planes 5-10 of the 11-channel one bit for
    bit; the strays are the same samples as the 11-channel launch's."""
    scal, (keym_s, p1, vl, p0), bits = _sorted_case(case, gather, exact_p0,
                                                    n)
    kw = dict(samples=SAMPLES, grid_hw=GRID,
              pscale=tdraw.pos_scale_for(GRID), p0=p0)
    tiles, strays = _tile_mirror(scal, keym_s, p1, vl, bits=bits,
                                 chunk=128, flow_off=True, **kw)
    want = tdraw.splat_plain(scal, p1, vl, flow_off=True, **kw)
    assert want.shape[0] == tdraw.N_VIEW
    assert torch.equal(tdraw.splat(scal, keym_s, p1, vl, idx_bits=bits,
                                   flow_off=True, **kw), want)
    assert torch.equal(want, tdraw.splat_plain(scal, p1, vl, **kw)[
        tdraw.N_FLOW:])
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1)
    assert (scale > 0).all()
    err = (tiles + strays - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    assert (err <= 1e-6 * scale).all(), (err, scale)
    fits, live, _ = _fits(scal, keym_s, p1, vl, bits=bits, flow_off=True,
                          **kw)
    assert (strays.abs().sum() > 0) == bool((live & ~fits).any())
    if case == "long":
        assert (live & ~fits).any()
