"""The port's fused draw against the JAX package's: pack (K1) + sort +
splat (K2) through `fused_draw_accumulate`, and the resolve (K3).

The JAX side runs its Pallas kernels in interpret mode on the CPU, the
port its plain versions (CPU tensors). Both get the same seeded inputs.
"""

import jax
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
    accum, _, aux, ride_s = tdraw.fused_draw_accumulate(
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


# The K1/K2 variants of the draws with the exact p0 stream and rgba8
# colours: (emit p0, gather mode 1), (emit p0, gather mode 0: no row ids),
# (key_recon: p0 re-derived in the splat, with a textured colour map).
VARIANTS = [("p0_rgba", 1), ("p0_rgba", 0), ("rgba", 1)]
VARIANT_IDS = ["p0-rgba8-gather1", "p0-rgba8-gather0", "key-recon-rgba8"]


def _textured(c, seed=5):
    """The case with a per-particle colour-map lookup (`mapped`, already
    times colorMapAlpha) and some fast and some saturated colours."""
    rng = np.random.default_rng(seed)
    c = dict(c)
    c["mapped"] = (rng.uniform(0.0, 1.5, (4, c["idx"].size))
                   * np.float32(0.4)).astype(np.float32)
    return c


def _pack_scal(c, recon):
    """The pack's `f32[1, 32]` scalars as the JAX `fused_draw_accumulate`
    builds them (slots 30/31 hold the view size only for key_recon)."""
    tail = np.zeros(17, np.float32)
    if recon:
        tail[15:17] = c["vs"]
    return np.concatenate([
        np.asarray([SPEED_LIMIT, TIME, 5.0, 1.0, 1e-6, c["sin_decay"],
                    FLOW_DECAY], np.float32),
        c["base"], c["flow_color"], tail]).astype(np.float32)[None]


def _jax_pack(c, grid_hw, variant, gather):
    """JAX `_pack_kernel` through `pallas_call` (interpret mode), one block
    of all N rows: (keym, p0 or None, p1, vl, rgba)."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    h, w = grid_hw
    hp, wp = jdraw._pad_dims(h, w)
    n = c["idx"].size
    emit_p0 = variant.startswith("p0")
    j = jnp.asarray
    ins = [j(_pack_scal(c, not emit_p0)), j(c["p0"][:, 0]), j(c["p0"][:, 1]),
           j(c["p1"][:, 0]), j(c["p1"][:, 1]), j(c["vel"][0]),
           j(c["vel"][1]), j(c["pos"][0]), j(c["pos"][1]),
           *(j(m) for m in c["mapped"]), j(c["live"])]
    if gather:
        ins.append(j(c["idx"]))
    spec = pl.BlockSpec((n,), lambda b: (b,))
    n_out = 5 if emit_p0 else 4
    outs = pl.pallas_call(
        functools.partial(jdraw._pack_kernel, tiles_x=wp // 256,
                          pscale=jdraw._pos_scale(hp, wp), h=h, w=w,
                          gather=gather, emit_p0=emit_p0, emit_rgba=True),
        grid=(1,),
        in_specs=[pl.BlockSpec((1, 32), lambda b: (0, 0),
                               memory_space=pltpu.SMEM)]
        + [spec] * (len(ins) - 1),
        out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.int32)] * n_out,
        interpret=True)(*ins)
    outs = [np.asarray(o) for o in outs]
    return (outs[0], outs[1] if emit_p0 else None, *outs[-3:])


def _torch_pack(c, grid_hw, variant, gather):
    t = torch.as_tensor
    emit_p0 = variant.startswith("p0")
    return tdraw.pack(
        t(_pack_scal(c, not emit_p0)[0]), t(c["p1"]), t(c["vel"]),
        t(c["live"]), t(c["idx"]) if gather else None, grid_hw=grid_hw,
        pscale=tdraw.pos_scale_for(grid_hw),
        p0_pix=t(c["p0"]) if emit_p0 else None, pos=t(c["pos"]),
        mapped=t(c["mapped"]))


def _rgba_fields(words):
    return np.stack([(words >> s) & m for s, m in
                     ((0, 255), (8, 255), (16, 255), (24, 127))])


@pytest.mark.parametrize("variant,gather", VARIANTS, ids=VARIANT_IDS)
def test_pack_variants_match_jax(variant, gather):
    """K1's plain version against the JAX `_pack_kernel`: keys, p0, p1 and
    velocity words bit for bit; each rgba8 field within one level of the
    jitted kernel (XLA on the CPU contracts the colour model's sums of
    products into FMAs) and bit for bit against `_pack_core` run op by
    op."""
    grid_hw = (64, 384)
    c = _textured(_case(grid_hw, 32))
    cuda_lib.reset_counts()
    t = [None if a is None else a.numpy()
         for a in _torch_pack(c, grid_hw, variant, gather)]
    assert cuda_lib.plain_calls["pack_" + variant] == 1
    keym, p0, p1, vl, rgba = _jax_pack(c, grid_hw, variant, gather)
    np.testing.assert_array_equal(t[0], keym)
    np.testing.assert_array_equal(t[1], p1)
    np.testing.assert_array_equal(t[2], vl)
    if p0 is None:
        assert t[3] is None
    else:
        np.testing.assert_array_equal(t[3], p0)
    d = np.abs(_rgba_fields(t[4]) - _rgba_fields(rgba))
    assert d.max() <= 1, f"{(d > 0).any(axis=0).sum()} words differ"
    assert (t[4] >= 0).all() and np.unique(t[4]).size > 100
    # Op by op (eager JAX, numpy output refs): the same f32 operations.
    n = c["idx"].size
    h, w = grid_hw
    hp, wp = jdraw._pad_dims(h, w)
    eager = {k: np.zeros(n, np.int32) for k in ("keym", "p0", "p1", "vl",
                                                "rgba")}
    j = jnp.asarray
    with jax.disable_jit():
        jdraw._pack_core(
            _pack_scal(c, p0 is None), j(c["p0"][:, 0]), j(c["p0"][:, 1]),
            j(c["p1"][:, 0]), j(c["p1"][:, 1]), j(c["vel"][0]),
            j(c["vel"][1]), j(c["pos"][0]), j(c["pos"][1]),
            *(j(m) for m in c["mapped"]), j(c["live"]), j(c["idx"]),
            eager["keym"], None if p0 is None else eager["p0"],
            eager["p1"], eager["vl"], eager["rgba"], [],
            tiles_x=wp // 256, pscale=jdraw._pos_scale(hp, wp), h=h, w=w,
            gather=gather, emit_rgba=True, key_recon=p0 is None)
    np.testing.assert_array_equal(t[4], eager["rgba"])


def _jax_accumulate(c, grid_hw, variant, gather):
    j = jnp.asarray
    recon = not variant.startswith("p0")
    n = c["idx"].size
    out = jdraw.fused_draw_accumulate(
        grid_hw, j(c["p0"]), j(c["p1"]), j(c["vel"]), j(c["pos"]),
        j(c["mapped"]), j(c["live"]), jnp.float32(SPEED_LIMIT),
        jnp.float32(TIME), idx=j(c["idx"]) if gather else None,
        ride=[j(c["pos"][0]), j(c["pos"][1])] if recon else None,
        idx_bound=n if recon else None, base_color=j(c["base"]),
        flow_color=j(c["flow_color"]),
        view_size=j(c["vs"]) if recon else None, interpret=True,
        **dict(_draw_kw(c), derive_p0=recon, raw_accum=False))
    aux = None if len(out) < 3 else (np.asarray(out[2][0])[:n],
                                     np.asarray(out[2][2])[:n])
    return [np.asarray(a) for a in (*out[0], *out[1])], aux


def _torch_accumulate(c, grid_hw, variant, gather):
    t = torch.as_tensor
    recon = not variant.startswith("p0")
    n = c["idx"].size
    fp, vp, aux, ride_s = tdraw.fused_draw_accumulate(
        grid_hw, None if recon else t(c["p0"]), t(c["p1"]), t(c["vel"]),
        t(c["pos"]), t(c["mapped"]), t(c["live"]), SPEED_LIMIT, TIME,
        idx=t(c["idx"]) if gather else None,
        ride=[t(c["pos"][0]), t(c["pos"][1])] if recon else None,
        idx_bound=n if recon else None, base_color=t(c["base"]),
        flow_color=t(c["flow_color"]),
        view_size=t(c["vs"]) if recon else None,
        **dict(_draw_kw(c), derive_p0=recon, raw_accum=False))
    assert (ride_s is None) == (not recon)
    return ([a.numpy() for a in (*fp, *vp)],
            None if aux is None else tuple(a.numpy() for a in aux))


@pytest.mark.parametrize("variant,gather", VARIANTS, ids=VARIANT_IDS)
def test_splat_variants_match_jax(variant, gather):
    """K2's plain version (p0 and rgba8 streams, through the port's
    `fused_draw_accumulate` without `raw_accum`) against the JAX
    accumulate parts `(num, wsum, logt)` of both passes: the TPU rounds
    its matmul operands to bf16, the port sums in f32. The aux streams
    of gather mode 1 bit for bit; the sorted ids are a permutation."""
    grid_hw = (64, 384)
    c = _textured(_case(grid_hw, 32))
    jparts, jaux = _jax_accumulate(c, grid_hw, variant, gather)
    cuda_lib.reset_counts()
    tparts, taux = _torch_accumulate(c, grid_hw, variant, gather)
    assert cuda_lib.plain_calls["splat_" + variant] == 1
    if gather:
        np.testing.assert_array_equal(taux[0], jaux[0])
        np.testing.assert_array_equal(taux[1], jaux[1])
        np.testing.assert_array_equal(np.sort(taux[0]),
                                      np.arange(c["idx"].size))
    else:
        assert taux is None and jaux is None
    for i, (t, j) in enumerate(zip(tparts, jparts)):
        assert t.shape == j.shape
        scale = np.abs(j).reshape(-1, *j.shape[-2:]).max(axis=(1, 2))
        assert (scale > 0).all(), i
        err = np.abs(t - j).reshape(-1, *j.shape[-2:]).max(axis=(1, 2))
        assert (err <= 1e-2 * scale).all(), (i, err, scale)
        assert np.abs(t.sum() - j.sum()) <= 5e-3 * np.abs(j).sum()


def test_box_blur_matches_jax():
    """The XLA tail's traced-radius box blur: the same edge-padded
    cumulative sums (XLA's CPU cumsum adds in another order)."""
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (6, 40, 130)).astype(np.float32)
    for radius in (0.4, 2.5, 3.5, 40.0):
        j = jdraw._box_blur_traced(jnp.asarray(img), jnp.float32(radius))
        t = tdraw._box_blur(torch.as_tensor(img), radius)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("widths", [(5.0, 1.0), (10.0, 12.0)],
                         ids=["narrow", "wide"])
def test_fused_draw_xla_tail_matches_jax(widths):
    """`fused_draw(resolve="xla")` (a draw with the exact p0 stream, rgba8
    colours and the XLA tail) against the JAX one: at flowWidth 10 and
    lineWidth 12 `_widen_excess` blurs both passes; at the defaults it is
    the identity. The grids within the deposits' bf16-vs-f32 tolerance."""
    grid_hw = (32, 128)
    h, w = grid_hw
    c = _textured(_case(grid_hw, 16))
    rng = np.random.default_rng(9)
    flow = rng.uniform(-0.02, 0.02, (4, h, w)).astype(np.float32)
    flow[2] = rng.uniform(0.0, TIME, (h, w))
    flow[3] = rng.uniform(0.0, 1.0, (h, w))
    view = rng.uniform(0.0, 1.0, (4, h, w)).astype(np.float32)
    from tendrils_tpu_torch import state as tstate
    params = tstate.default_state()
    params.update(flowWidth=widths[0], lineWidth=widths[1],
                  speedLimit=SPEED_LIMIT, flowDecay=FLOW_DECAY,
                  fadeColor=[0.1333, 0.1333, 0.1333, 0.05])
    tparams = tstate.params_from_state(params, device="cpu")
    tparams.update(autoClearView=torch.tensor(0.0),
                   autoFade=torch.tensor(1.0))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    j = jnp.asarray
    n = c["idx"].size
    jout = jdraw.fused_draw(
        j(flow), j(view), j(c["p0"]), j(c["p1"]), j(c["vel"]), j(c["pos"]),
        j(c["mapped"]), j(c["live"]), jparams, jnp.float32(TIME),
        grid_hw=grid_hw, samples=2, idx=jnp.arange(n, dtype=jnp.int32),
        interpret=True, resolve="xla")
    t = torch.as_tensor
    cuda_lib.reset_counts()
    tout = tdraw.fused_draw(
        t(flow), t(view), t(c["p0"]), t(c["p1"]), t(c["vel"]), t(c["pos"]),
        t(c["mapped"]), t(c["live"]), tparams, torch.tensor(TIME),
        grid_hw=grid_hw, samples=2,
        idx=torch.arange(n, dtype=torch.int32), resolve="xla",
        host_widths=widths)
    assert cuda_lib.plain_calls["resolve"] == 0
    np.testing.assert_array_equal(tout[2][1].numpy(),
                                  np.asarray(jout[2][2])[:n])
    for name, a, b in (("flow", tout[0], jout[0]), ("view", tout[1],
                                                    jout[1])):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b).reshape(4, -1).max(axis=1)
        err = np.abs(a - b).reshape(4, -1).max(axis=1)
        assert (err <= 1e-2 * scale).all(), (name, err, scale)
        assert not np.array_equal(b, (flow if name == "flow" else view))
