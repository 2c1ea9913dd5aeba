"""The port's fused draw against the JAX package's: pack (K1) + sort +
splat (K2) through `fused_draw_accumulate`, and the resolve (K3).

The JAX side runs its Pallas kernels in interpret mode on the CPU, the
port its plain versions (CPU tensors). Both get the same seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu.ops import draw_pallas as jdraw
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.ops import cuda_lib, draw_cuda as tdraw
from tendrils_tpu_torch.ops.tile_geom import HALF

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

GRIDS = [((32, 128), 16), ((64, 384), 32)]
SPEED_LIMIT = 0.03
TIME = 160.0
FLOW_DECAY = 0.005


def _case(grid_hw, root, seed=0):
    """A resident draw's inputs: positions after a step, velocities within
    the speed limit, a tenth of the rows dead, permuted row ids."""
    rng = np.random.default_rng(seed)
    h, w = grid_hw
    n = root * root
    vs = (np.float32(max(h, w)) / np.asarray([w, h], np.float32))
    pos = (rng.uniform(-1.02, 1.02, (2, n)) / vs[:, None]).astype(np.float32)
    vel = (rng.uniform(-0.7, 0.7, (2, n)) * SPEED_LIMIT).astype(np.float32)
    dead = rng.random(n) < 0.1
    pos[:, dead] = INERT
    vel[:, dead] = 0.0
    p1 = np.stack([(pos[0] * vs[0] * np.float32(0.5) + np.float32(0.5)) * w,
                   (pos[1] * vs[1] * np.float32(0.5) + np.float32(0.5)) * h],
                  axis=-1).astype(np.float32)
    p0 = (p1 - vel.T * vs * np.float32(0.5)
          * np.asarray([w, h], np.float32)).astype(np.float32)
    return dict(
        p0=p0, p1=p1, vel=vel, pos=pos, live=(~dead).astype(np.float32),
        idx=rng.permutation(n).astype(np.int32), vs=vs,
        mapped=(np.asarray([0.2, 0.5, 0.8, 1.0], np.float32)
                * np.float32(0.4)),
        base=np.asarray([1.0, 1.0, 1.0, 0.5], np.float32),
        flow_color=np.asarray([1.0, 1.0, 1.0, 0.04], np.float32),
        sin_decay=np.sin(np.float32(TIME) * np.float32(FLOW_DECAY)))


def _draw_kw(c):
    return dict(samples=2, flow_width=5.0, line_width=1.0, speed_alpha=1e-6,
                sin_decay=float(c["sin_decay"]), flow_decay=FLOW_DECAY,
                derive_p0=True, raw_accum=True)


def _jax_draw(grid_hw, c):
    j = jnp.asarray
    accum, _, aux, ride_s, _ = jdraw.fused_draw_accumulate(
        grid_hw, j(c["p0"]), j(c["p1"]), j(c["vel"]), j(c["pos"]), None,
        j(c["live"]), jnp.float32(SPEED_LIMIT), jnp.float32(TIME),
        idx=j(c["idx"]), ride=[j(c["pos"][0]), j(c["pos"][1])],
        idx_bound=c["idx"].size, base_color=j(c["base"]),
        flow_color=j(c["flow_color"]), view_size=j(c["vs"]),
        mapped_scalar=j(c["mapped"]), interpret=True, **_draw_kw(c))
    n = c["idx"].size
    # The TPU pads to block multiples; pad rows sort last.
    return (np.asarray(accum), np.asarray(aux[0])[:n],
            np.asarray(aux[2])[:n], [np.asarray(r)[:n] for r in ride_s])


def _torch_draw(grid_hw, c):
    t = torch.as_tensor
    accum, aux, ride_s = tdraw.fused_draw_accumulate(
        grid_hw, None, t(c["p1"]), t(c["vel"]), None, None, t(c["live"]),
        SPEED_LIMIT, TIME, idx=t(c["idx"]),
        ride=[t(c["pos"][0]), t(c["pos"][1])], idx_bound=c["idx"].size,
        base_color=t(c["base"]), flow_color=t(c["flow_color"]),
        view_size=t(c["vs"]), mapped_scalar=t(c["mapped"]), **_draw_kw(c))
    return (accum.numpy(), aux[0].numpy(), aux[1].numpy(),
            [r.numpy() for r in ride_s])


@pytest.mark.parametrize("grid_hw,root", GRIDS)
def test_pack_sort_splat_matches_jax(grid_hw, root):
    c = _case(grid_hw, root)
    ja, jidx, jp1, jride = _jax_draw(grid_hw, c)
    ta, tidx, tp1, tride = _torch_draw(grid_hw, c)
    # Integer streams are the contract: bit-exact. Keys are unique (row id
    # in the low 20 bits), so equal sorted ids pin the pack's keys.
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tp1, jp1)
    np.testing.assert_array_equal(tride[2], jride[2])  # vl words
    np.testing.assert_array_equal(tride[0], jride[0])  # exact positions
    np.testing.assert_array_equal(tride[1], jride[1])
    assert ta.shape == ja.shape
    # The accumulator: the TPU kernel rounds its matmul operands to bf16
    # (draw_pallas.py:464,473, ~0.4 % per operand); the port sums in f32.
    scale = np.abs(ja).reshape(ja.shape[0], -1).max(axis=1)
    assert (scale > 0).all()
    assert (np.abs(ta - ja) <= 1e-2 * scale[:, None, None]).all()
    # Deposit totals within 5e-3 of each channel's mass (the velocity
    # channels are signed, so their sums cancel: measure against sum |.|).
    mass = np.abs(ja).sum(axis=(1, 2))
    assert (np.abs(ta.sum(axis=(1, 2)) - ja.sum(axis=(1, 2)))
            <= 5e-3 * mass).all()


@pytest.mark.parametrize("grid_hw,root", GRIDS)
def test_resolve_matches_jax(grid_hw, root):
    rng = np.random.default_rng(1)
    h, w = grid_hw
    c = _case(grid_hw, root)
    accum = _torch_draw(grid_hw, c)[0]
    flow = rng.uniform(-0.02, 0.02, (4, h, w)).astype(np.float32)
    flow[2] = rng.uniform(0.0, TIME, (h, w))
    flow[3] = rng.uniform(0.0, 1.0, (h, w))
    view = rng.uniform(0.0, 1.0, (4, h, w)).astype(np.float32)
    fade = np.asarray([0.1333, 0.1333, 0.1333, 0.05], np.float32)
    args = (fade, 0.0, TIME, TIME + 1000.0 / 60.0, FLOW_DECAY, 5.0, 1.0)
    jout = jdraw.resolve_fused(
        jnp.asarray(accum), jnp.asarray(flow), jnp.asarray(view),
        *(jnp.asarray(a, jnp.float32) for a in args), want_eff=True,
        interpret=True)
    tout = tdraw.resolve_fused(
        torch.as_tensor(accum), torch.as_tensor(flow), torch.as_tensor(view),
        *args, want_eff=True)
    # Same formula in f32 on both sides; exp differs by an ulp between XLA
    # and torch, and the flow velocities are signed (cancellation near 0
    # needs the absolute floor).
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def _resident_streams(m, seed=3):
    """Sorted-stream rows of a resident frame: exact positions, a fifth
    of them INERT, and q15 velocity words with the live bit."""
    rng = np.random.default_rng(seed)
    npx = rng.uniform(-1, 1, m).astype(np.float32)
    npy = rng.uniform(-1, 1, m).astype(np.float32)
    inert = rng.random(m) < 0.2
    npx[inert] = INERT
    npy[inert] = INERT
    qx, qy = rng.integers(0, HALF + 1, (2, m)).astype(np.int32)
    vl = ((~inert).astype(np.int32) << 30) + qy * (HALF + 1) + qx
    return npx, npy, vl, inert


@pytest.mark.parametrize("m", [3000, 4096])
def test_reconstruct_resident_matches_jax(m):
    """K6 (plain version on the CPU) against the JAX `reconstruct_resident`
    and the body it shares with K4, `draw_pallas.reconstruct_rows`."""
    npx, npy, vl, inert = _resident_streams(m)
    sl = np.float32(0.01)
    cuda_lib.reset_counts()
    t = tdraw.reconstruct_resident(*(torch.as_tensor(a)
                                     for a in (npx, npy, vl, sl)))
    assert cuda_lib.plain_calls["reconstruct_resident"] == 1
    t = [a.numpy() for a in t]
    # The shared body run op by op (eager JAX, numpy output refs): the
    # same f32 operations, bit for bit.
    part, prev = np.zeros((4, m), np.float32), np.zeros((4, m), np.float32)
    jdraw.reconstruct_rows(jnp.float32(sl), jnp.asarray(npx),
                           jnp.asarray(npy), jnp.asarray(vl), part, prev)
    np.testing.assert_array_equal(t[0], part)
    np.testing.assert_array_equal(t[1], prev)
    # The Pallas kernel in interpret mode is jitted, and XLA on the CPU
    # contracts the q15 decode `q * (2/HALF) - 1` into an FMA: an ulp of 1,
    # times speedLimit, and an ulp of the position in pos - vel (as for K4,
    # tests/test_torch_gather.py).
    jout = jdraw.reconstruct_resident(jnp.asarray(npx), jnp.asarray(npy),
                                      jnp.asarray(vl), sl, interpret=True)
    for a, b in zip(t, jout):
        np.testing.assert_allclose(a, np.asarray(b)[:, :m], rtol=1e-6,
                                   atol=2 * 2.0 ** -24 * sl)
    np.testing.assert_array_equal(t[1][0][inert], INERT)
