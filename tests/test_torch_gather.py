"""The port's gathers against the JAX package's Pallas gathers (interpret
mode): K5 `bilinear_gather`, K4 `gather_reconstruct_p1`, K8
`bilinear_gather_keyed_p1`, K7 `bilinear_gather_keyed_q15` and K12
`bilinear_gather_keyed`, including points on and past the last row and
column, and INERT rows; and the keyed gathers' launch layout (K12's read
from `csrc/gather.cu` and transcribed)."""

import functools
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu.ops import gather_pallas as jgather, sample as jsample
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.ops import cuda_lib, gather_cuda as tgather
from tendrils_tpu_torch.ops.draw_cuda import (pos_scale_for,
                                              reconstruct_resident)
from tendrils_tpu_torch.ops.tile_geom import (HALF, PAD_LO_H, PAD_LO_W,
                                              REGION_H, REGION_W, TILE_H,
                                              TILE_W, pad_dims)

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

# (32, 128): the JAX kernel reads a padded copy of the grid; (64, 384): it
# reads the content layout with clamped region DMAs.
GRIDS = [(32, 128), (64, 384)]
# The port against the gather's contract, `sample.bilinear_sample`: the
# same f32 lerps, relative 1e-5 with an absolute floor for the signed values
# near 0.
RTOL, ATOL = 1e-5, 1e-6


def _edge_points(rng, h, w, m):
    """Random points inside and beyond the grid, plus points exactly on the
    last texel centres and past the last row and column."""
    x = rng.uniform(-3, w + 3, m).astype(np.float32)
    y = rng.uniform(-3, h + 3, m).astype(np.float32)
    ex = np.asarray([w - 0.5, w - 0.5, w, w + 2, 0.5, w - 0.75], np.float32)
    ey = np.asarray([h - 0.5, 0.5, h - 0.5, h, h + 2, h - 0.75], np.float32)
    return np.concatenate([x, ex]), np.concatenate([y, ey])


def _tile_points(rng, m, ty, tx):
    """`m` points inside the padded grid's tile (ty, tx), in content
    coords."""
    x = rng.uniform(tx * TILE_W, (tx + 1) * TILE_W, m) - PAD_LO_W
    y = rng.uniform(ty * TILE_H, (ty + 1) * TILE_H, m) - PAD_LO_H
    return x.astype(np.float32), y.astype(np.float32)


# K5 on points spread over and past each grid, and on points all in one
# tile (neighbouring points share texels).
@pytest.mark.parametrize("grid_hw, one_tile", [
    *(pytest.param(g, False, id=f"grid_hw{i}") for i, g in enumerate(GRIDS)),
    pytest.param((64, 384), True, id="one_tile")])
def test_bilinear_gather_matches_jax(grid_hw, one_tile):
    rng = np.random.default_rng(0)
    h, w = grid_hw
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    x, y = (_tile_points(rng, 3000, 2, 1) if one_tile
            else _edge_points(rng, h, w, 3000))
    jargs = (jnp.asarray(grid), jnp.asarray(x), jnp.asarray(y))
    t = tgather.bilinear_gather(torch.as_tensor(grid), torch.as_tensor(x),
                                torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(t, np.asarray(jsample.bilinear_sample(*jargs)),
                               rtol=RTOL, atol=ATOL)
    # The TPU kernel itself samples in padded coordinates (x + PAD_LO_W),
    # which rounds away ~8 bits of the texel fraction: its own test holds it
    # to the contract at atol 1e-4 (tests/test_gather_pallas.py).
    np.testing.assert_allclose(
        t, np.asarray(jgather.bilinear_gather(*jargs, interpret=True)),
        atol=1e-4)


@pytest.mark.parametrize("grid_hw", GRIDS)
def test_gather_reconstruct_matches_jax(grid_hw):
    rng = np.random.default_rng(1)
    h, w = grid_hw
    m = 3000
    pscale = pos_scale_for(grid_hw)
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    x, y = _edge_points(rng, h, w, m)
    m = x.size
    # Packed p1 words (x, y in padded px at 1/pscale), as the pack emits.
    xq = np.rint(np.clip(x + PAD_LO_W, 1, PAD_LO_W + w + 1) * pscale)
    yq = np.rint(np.clip(y + PAD_LO_H, 1, PAD_LO_H + h + 1) * pscale)
    p1 = (yq.astype(np.int32) * (HALF + 1) + xq.astype(np.int32))
    # The JAX keyed gather needs each row's tile key (the draw's aux
    # stream); the row's own tile of its clamped p1 satisfies the contract.
    inv_p = 1.0 / pscale
    xs = np.clip(xq * inv_p, PAD_LO_W + 0.5, PAD_LO_W + w - 0.5)
    ys = np.clip(yq * inv_p, PAD_LO_H + 0.5, PAD_LO_H + h - 0.5)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    keys = ((np.floor(ys - 0.5).astype(np.int32) // TILE_H) * tiles_x
            + np.floor(xs - 0.5).astype(np.int32) // TILE_W)
    npx = rng.uniform(-1, 1, m).astype(np.float32)
    npy = rng.uniform(-1, 1, m).astype(np.float32)
    inert = rng.random(m) < 0.2
    npx[inert] = INERT
    npy[inert] = INERT
    qx, qy = rng.integers(0, HALF + 1, (2, m)).astype(np.int32)
    vl = ((~inert).astype(np.int32) << 30) + qy * (HALF + 1) + qx
    sl = np.float32(0.01)
    jout = jgather.gather_reconstruct_p1(
        jnp.asarray(grid), jnp.asarray(p1), jnp.asarray(keys),
        jnp.asarray(npx), jnp.asarray(npy), jnp.asarray(vl), sl,
        inv_p=inv_p, interpret=True)
    t = torch.as_tensor
    tout = tgather.gather_reconstruct_p1(t(grid), t(p1), t(npx), t(npy),
                                         t(vl), t(sl), inv_p=inv_p)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0])[:, :m],
                               rtol=RTOL, atol=ATOL)
    # The reassembly is the same f32 arithmetic, but jitted XLA on the CPU
    # contracts the q15 decode `q * (2/HALF) - 1` into an FMA: an ulp of 1,
    # times speedLimit.
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :m],
                                   rtol=1e-6, atol=2 * 2.0 ** -24 * sl)
    # INERT rows keep their position in `previous` (no pos - vel).
    prev = tout[2].numpy()
    np.testing.assert_array_equal(prev[0][inert], INERT)
    np.testing.assert_array_equal(prev[1][inert], INERT)
    assert (prev[0][~inert] != npx[~inert]).mean() > 0.5


def _p1_case(rng, grid_hw, m):
    """Packed p1 words for points inside, on and past every edge, with
    the JAX keyed gathers' tile keys (the row's own tile of its clamped
    p1 satisfies their contract)."""
    h, w = grid_hw
    pscale = pos_scale_for(grid_hw)
    x, y = _edge_points(rng, h, w, m)
    xq = np.rint(np.clip(x + PAD_LO_W, 1, PAD_LO_W + w + 1) * pscale)
    yq = np.rint(np.clip(y + PAD_LO_H, 1, PAD_LO_H + h + 1) * pscale)
    p1 = (yq.astype(np.int32) * (HALF + 1) + xq.astype(np.int32))
    inv_p = 1.0 / pscale
    xs = np.clip(xq * inv_p, PAD_LO_W + 0.5, PAD_LO_W + w - 0.5)
    ys = np.clip(yq * inv_p, PAD_LO_H + 0.5, PAD_LO_H + h - 0.5)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    keys = ((np.floor(ys - 0.5).astype(np.int32) // TILE_H) * tiles_x
            + np.floor(xs - 0.5).astype(np.int32) // TILE_W)
    return p1, keys, inv_p


@pytest.mark.parametrize("grid_hw", GRIDS)
def test_bilinear_gather_keyed_p1_matches_jax(grid_hw):
    """K8 (plain version on the CPU) against the JAX keyed p1 gather, at
    the gathers' tolerance (the same lerps; the TPU kernel sums one-hot
    matmul rows)."""
    rng = np.random.default_rng(2)
    h, w = grid_hw
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    p1, keys, inv_p = _p1_case(rng, grid_hw, 3000)
    jout = jgather.bilinear_gather_keyed_p1(
        jnp.asarray(grid), jnp.asarray(p1), jnp.asarray(keys), inv_p=inv_p,
        interpret=True)
    cuda_lib.reset_counts()
    tout = tgather.bilinear_gather_keyed_p1(torch.as_tensor(grid),
                                            torch.as_tensor(p1), inv_p=inv_p)
    assert cuda_lib.plain_calls["gather_keyed_p1"] == 1
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[:, :p1.size],
                               rtol=RTOL, atol=ATOL)


def test_gather_reconstruct_is_keyed_gather_plus_reconstruct():
    """K4 == K8 + K6, bit for bit (the JAX package asserts the same of its
    kernels, tests/test_gather_pallas.py); `chip_smoke.py` checks the
    kernels themselves on the card."""
    rng = np.random.default_rng(4)
    h, w = GRIDS[0]
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    p1, _, inv_p = _p1_case(rng, (h, w), 2000)
    m = p1.size
    npx = rng.uniform(-1, 1, m).astype(np.float32)
    npy = rng.uniform(-1, 1, m).astype(np.float32)
    npx[::5] = INERT
    npy[::5] = INERT
    vl = rng.integers(0, 1 << 31, m).astype(np.int32)
    t = torch.as_tensor
    sl = t(np.float32(0.02))
    fused = tgather.gather_reconstruct_p1(t(grid), t(p1), t(npx), t(npy),
                                          t(vl), sl, inv_p=inv_p)
    parts = (tgather.bilinear_gather_keyed_p1(t(grid), t(p1), inv_p=inv_p),
             *reconstruct_resident(t(npx), t(npy), t(vl), sl))
    for a, b in zip(fused, parts):
        assert torch.equal(a, b)


def _pack_p1(x, y, pscale):
    """Content coords to packed p1 words at `1/pscale` padded px."""
    xq = np.rint((x + PAD_LO_W) * pscale).astype(np.int32)
    yq = np.rint((y + PAD_LO_H) * pscale).astype(np.int32)
    return yq * (HALF + 1) + xq


def _gather_keys(p1, seg_keys, grid_hw):
    """The draw's gather keys (draw_pallas.py:970-987): a row's segment key
    where both bilinear corners of its clamped p1 lie in that key tile's
    region, else the p1's own tile; and the own tiles."""
    h, w = grid_hw
    inv_p = 1.0 / pos_scale_for(grid_hw)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    xs = np.clip((p1 & HALF).astype(np.float32) * np.float32(inv_p),
                 PAD_LO_W + 0.5, PAD_LO_W + w - 0.5)
    ys = np.clip((p1 >> 15).astype(np.float32) * np.float32(inv_p),
                 PAD_LO_H + 0.5, PAD_LO_H + h - 0.5)
    r0 = np.floor(ys - 0.5).astype(np.int32)
    c0 = np.floor(xs - 0.5).astype(np.int32)
    kr, kc = seg_keys // tiles_x, seg_keys % tiles_x
    fits = ((r0 >= kr * TILE_H) & (c0 >= kc * TILE_W)
            & (r0 + 1 < kr * TILE_H + REGION_H)
            & (c0 + 1 < kc * TILE_W + REGION_W))
    own = (r0 // TILE_H) * tiles_x + c0 // TILE_W
    return np.where(fits, seg_keys, own).astype(np.int32), own


def _sorted_p1_case(rng, grid_hw, m, stream):
    """A draw's sorted rows: packed p1 words in segment-key order and the
    gather keys. "tiles": rows of three tiles (two side by side, one in the
    tile row below), each row keyed by its own tile, so one run of sorted
    rows spans tiles. "long": rows spread over the grid whose segment key
    is the tile at the top-left of the box from p0 to p1, with p0 anywhere
    on the grid for a fifth of them (long segments: their p1 lies outside
    their key's tile, and the gather key falls back to the p1's tile)."""
    h, w = grid_hw
    pscale = pos_scale_for(grid_hw)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    if stream == "tiles":
        pts = [_tile_points(rng, m // 3, ty, tx)
               for ty, tx in ((1, 1), (1, 2), (2, 1))]
        x = np.concatenate([p[0] for p in pts])
        y = np.concatenate([p[1] for p in pts])
        p0x, p0y = x, y
    else:
        x = rng.uniform(0, w, m).astype(np.float32)
        y = rng.uniform(0, h, m).astype(np.float32)
        far = rng.random(m) < 0.2
        p0x = np.where(far, rng.uniform(0, w, m), x - 3.0)
        p0y = np.where(far, rng.uniform(0, h, m), y - 2.0)
    p1 = _pack_p1(x, y, pscale)
    top = np.clip(np.minimum(p0y, y) - 3.0 + PAD_LO_H, 0, None)
    left = np.clip(np.minimum(p0x, x) - 3.0 + PAD_LO_W, 0, None)
    seg = ((top // TILE_H).astype(np.int32) * tiles_x
           + (left // TILE_W).astype(np.int32))
    order = np.argsort(seg, kind="stable")
    p1, seg = p1[order], seg[order]
    keys, own = _gather_keys(p1, seg, grid_hw)
    if stream == "long":
        # p1 outside its key's tile; beyond its region, the p1's own key.
        assert (own != seg).mean() > 0.1 and (keys != seg).any()
    return p1, keys, 1.0 / pscale


# K7 on random rows with their own tile keys, and on sorted runs of rows as
# a kernel block takes them: rows of several tiles, and long segments whose
# p1 has left their key's tile.
@pytest.mark.parametrize("grid_hw, stream", [
    *(pytest.param(g, "edges", id=f"grid_hw{i}")
      for i, g in enumerate(GRIDS)),
    pytest.param((64, 384), "tiles", id="sorted_tiles"),
    pytest.param((64, 384), "long", id="long_segments")])
def test_bilinear_gather_keyed_q15_matches_jax(grid_hw, stream):
    """K7 (plain version on the CPU) against the JAX q15 keyed gather: the
    TPU kernel sums one-hot matmul rows where the port lerps, so a field
    may round to the other side of a q15 step (the JAX test's own bound,
    tests/test_gather_pallas.py:113-116)."""
    rng = np.random.default_rng(5)
    h, w = grid_hw
    sl = np.float32(0.02)
    grid = rng.uniform(-1.5, 1.5, (2, h, w)).astype(np.float32) * sl
    p1, keys, inv_p = (_p1_case(rng, grid_hw, 3000) if stream == "edges"
                       else _sorted_p1_case(rng, grid_hw, 3000, stream))
    inv_sl = np.float32(1.0) / sl
    jout = np.asarray(jgather.bilinear_gather_keyed_q15(
        jnp.asarray(grid), jnp.asarray(p1), jnp.asarray(keys),
        jnp.float32(inv_sl), inv_p=inv_p, interpret=True))[:p1.size]
    cuda_lib.reset_counts()
    tout = tgather.bilinear_gather_keyed_q15(
        torch.as_tensor(grid), torch.as_tensor(p1), torch.tensor(inv_sl),
        inv_p=inv_p).numpy()
    assert cuda_lib.plain_calls["gather_keyed_q15"] == 1
    for shift in (0, 15):
        d = np.abs(((tout >> shift) & HALF).astype(np.int64)
                   - ((jout >> shift) & HALF))
        assert d.max() <= 1
    # Clamped at +-speedLimit, so some fields saturate at 0 and HALF.
    assert ((tout & HALF) == HALF).any() and ((tout & HALF) == 0).any()
    assert (tout >= 0).all()


@functools.lru_cache(maxsize=None)
def _keyed_draw():
    """A fused draw's sorted streams (its gather keys and packed p1) on a
    64 x 384 grid, n = 1024, and the state of the generator after it."""
    from tendrils_tpu.ops import draw_pallas as jdraw
    rng = np.random.default_rng(6)
    h, w = 64, 384
    n = 1024
    vs = np.float32(max(h, w)) / np.asarray([w, h], np.float32)
    pos = (rng.uniform(-1.02, 1.02, (2, n)) / vs[:, None]).astype(np.float32)
    vel = (rng.uniform(-0.7, 0.7, (2, n)) * 0.03).astype(np.float32)
    p1 = np.stack([(pos[0] * vs[0] * np.float32(0.5) + np.float32(0.5)) * w,
                   (pos[1] * vs[1] * np.float32(0.5) + np.float32(0.5)) * h],
                  axis=-1).astype(np.float32)
    p0 = (p1 - vel.T * vs * np.float32(0.5)
          * np.asarray([w, h], np.float32)).astype(np.float32)
    j = jnp.asarray
    _, _, aux = jdraw.fused_draw_accumulate(
        (h, w), j(p0), j(p1), j(vel), j(pos), j(np.ones((4, n), np.float32)),
        j(np.ones(n, np.float32)), jnp.float32(0.03), jnp.float32(100.0),
        idx=jnp.arange(n, dtype=jnp.int32), interpret=True, samples=2)
    gkey, p1_s = (np.asarray(a)[:n] for a in aux[1:])
    return (h, w), gkey, p1_s, rng.bit_generator.state


# K12 with 1, 2 and 3 channels, on a whole number of 1024-point blocks and
# on a part block.
@pytest.mark.parametrize("m", [1024, 1000])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_bilinear_gather_keyed_matches_jax(c, m):
    """K12 (plain version on the CPU) against the JAX keyed gather on a
    fused draw's sorted streams (its gather keys and packed p1, unpacked
    and clamped to padded float coords as the draw's aux contract has it;
    the first `m` points), at the JAX test's own bound
    (tests/test_gather_pallas.py:69-71)."""
    (h, w), gkey, p1_s, state = _keyed_draw()
    gkey, p1_s = gkey[:m], p1_s[:m]
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    inv_p = 1.0 / pos_scale_for((h, w))
    xs = np.clip((p1_s & HALF).astype(np.float32) * np.float32(inv_p),
                 PAD_LO_W + 0.5, PAD_LO_W + w - 0.5).astype(np.float32)
    ys = np.clip((p1_s >> 15).astype(np.float32) * np.float32(inv_p),
                 PAD_LO_H + 0.5, PAD_LO_H + h - 0.5).astype(np.float32)
    grid = rng.uniform(-2, 2, (c, h, w)).astype(np.float32)
    j = jnp.asarray
    jout = jgather.bilinear_gather_keyed(j(grid), j(xs), j(ys), j(gkey),
                                         interpret=True)
    cuda_lib.reset_counts()
    tout = tgather.bilinear_gather_keyed(*(torch.as_tensor(a)
                                           for a in (grid, xs, ys)))
    assert cuda_lib.plain_calls["gather_keyed"] == 1
    assert tout.shape == (c, m)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=5e-4)
    # On the clamped domain it is CLAMP_TO_EDGE sampling.
    np.testing.assert_allclose(
        tout.numpy(), np.asarray(jsample.bilinear_sample(
            j(grid), j(xs - PAD_LO_W), j(ys - PAD_LO_H))), atol=5e-4)


def test_bilinear_gather_keyed_zero_outside_content():
    """K12's corners outside the content weigh 0 (the TPU's zero padding):
    a point half a texel past the last column reads half the edge texel."""
    grid = torch.ones((1, 16, 128))
    xs = torch.tensor([PAD_LO_W + 128.0, PAD_LO_W + 64.5])
    ys = torch.tensor([PAD_LO_H + 8.5, PAD_LO_H + 16.0])
    np.testing.assert_allclose(
        tgather.bilinear_gather_keyed(grid, xs, ys).numpy(), [[0.5, 0.5]])


# K7's and K8's launch: blocks of KEYED_THREADS threads over consecutive
# sorted rows, r rows a thread sized from n (H100: 132 SMs).
@pytest.mark.parametrize("n, sms, want", [
    (1 << 20, 132, (8, 128)),        # config 2: one block an SM
    (512 * 512, 132, (2, 128)),      # path B, config 4
    (1 << 22, 132, (8, 264)),        # config 3: two waves, then a stride
    (1 << 24, 132, (8, 264)),        # config 5
    (1000, 132, (1, 1)),
    (1, 4, (1, 1)),
])
def test_keyed_layout_sizes_rows_from_n(n, sms, want):
    """`keyed_layout`: r = min(8, max(1, ceil(n / (sms x 1024)))), blocks
    of 1024 x r rows, at most two an SM; together they cover every row
    (the blocks stride over the spans past the first two waves); the
    kernel's block size is the wrapper's."""
    r, blocks = tgather.keyed_layout(n, sms)
    assert (r, blocks) == want
    span = tgather.KEYED_THREADS * r
    assert blocks <= 2 * sms and blocks * span >= min(n, 2 * sms * span)
    assert -(-n // span) <= blocks or blocks == 2 * sms
    src = (pathlib.Path(tgather.__file__).resolve().parents[1] / "csrc"
           / "gather.cu").read_text()
    assert f"KEYED_THREADS = {tgather.KEYED_THREADS};" in src


GATHER_CU = (pathlib.Path(tgather.__file__).resolve().parents[1] / "csrc"
             / "gather.cu").read_text()


def _k12_source():
    """`gather_keyed_kernel` and its C entry, whitespace collapsed."""
    m = re.search(r"__global__ void __launch_bounds__\(KEYED_THREADS, 2\)"
                  r"\s+gather_keyed_kernel\(.*?\n}\n", GATHER_CU, re.S)
    assert m, "gather_keyed_kernel with K7's launch bounds"
    entry = re.search(r'extern "C" int tt_gather_keyed\(.*?\n}\n',
                      GATHER_CU, re.S)
    assert entry
    return " ".join(m.group(0).split()), " ".join(entry.group(0).split())


def test_k12_launch_is_k7s():
    """K12 runs K7's blocks: KEYED_THREADS threads, point base + thread +
    k x KEYED_THREADS for k < r, the blocks striding over spans of
    KEYED_THREADS x r points; the loop transcribed below is this one."""
    kernel, entry = _k12_source()
    assert f"constexpr int KEYED_THREADS = {tgather.KEYED_THREADS};" \
        in GATHER_CU
    for expr in ("const long long span = (long long)KEYED_THREADS * r;",
                 "for (long long base = blockIdx.x * span; base < m; "
                 "base += gridDim.x * span) {",
                 "for (int k = 0; k < r; ++k) {",
                 "const long long i = base + threadIdx.x + (long long)k * "
                 "KEYED_THREADS;",
                 "if (i >= m) break;"):
        assert expr in kernel, expr
    assert "gather_keyed_kernel<<<blocks, KEYED_THREADS, 0," in entry


def _k12_visits(m, r, blocks):
    """How often the transcribed K12 loop visits each point of [0, m)."""
    t = tgather.KEYED_THREADS
    span = t * r
    seen = np.zeros(m, np.int64)
    lanes = np.arange(t)
    for b in range(blocks):
        for base in range(b * span, m, blocks * span):
            for k in range(r):
                i = base + lanes + k * t
                np.add.at(seen, i[i < m], 1)
    return seen


@pytest.fixture
def card(monkeypatch):
    """K12's wrapper on CPU tensors as if they lay on a card of 132 SMs:
    the launch's arguments recorded in `card.calls`."""
    fake = types.SimpleNamespace(sms=132, calls=[])

    def launch(name, counter, *args, kernels=1):
        fake.calls.append((name, counter, args))

    monkeypatch.setattr(cuda_lib, "on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_lib, "launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=fake.sms))
    return fake


@pytest.mark.parametrize("m, sms", [
    (1, 132), (1000, 132),
    (tgather.KEYED_THREADS * 8 + 1, 1),  # a span of r = 8, then one point
    (1 << 20, 132),                      # config 2: one block an SM
    (1 << 22, 132),                      # config 3: the blocks stride
])
def test_k12_wrapper_launches_keyed_layout(card, m, sms):
    """The wrapper passes `keyed_layout(m, SMs)` as (r, blocks), and that
    layout visits every point of [0, m) exactly once."""
    card.sms = sms
    grid = torch.zeros((2, 4, 8))
    xs = torch.zeros(m)
    out = tgather.bilinear_gather_keyed(grid, xs, xs)
    (name, counter, args), = card.calls
    assert (name, counter) == ("tt_gather_keyed", "gather_keyed")
    r, blocks = tgather.keyed_layout(m, sms)
    assert args[6:9] == (m, r, blocks) and args[9] is out
    assert out.shape == (2, m)
    assert (_k12_visits(m, r, blocks) == 1).all()


def test_pair_scratch_is_kept_per_shape():
    """K5's interleaved pair is allocated once per (h, w, device)."""
    a = tgather._pair_scratch(6, 10, torch.device("cpu"))
    assert a.shape == (6, 10, 2) and a.dtype == torch.float32
    assert tgather._pair_scratch(6, 10, torch.device("cpu")) is a
    assert tgather._pair_scratch(6, 12, torch.device("cpu")) is not a
