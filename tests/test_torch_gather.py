"""The port's gathers against the JAX package's Pallas gathers (interpret
mode): K5 `bilinear_gather`, K4 `gather_reconstruct_p1` and K8
`bilinear_gather_keyed_p1`, including points on and past the last row and
column, and INERT rows."""

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
                                              TILE_H, TILE_W, pad_dims)

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


@pytest.mark.parametrize("grid_hw", GRIDS)
def test_bilinear_gather_matches_jax(grid_hw):
    rng = np.random.default_rng(0)
    h, w = grid_hw
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    x, y = _edge_points(rng, h, w, 3000)
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
