"""The port's fused draw in gather modes 2 and 3 against the JAX package's,
at small N: the JAX picks mode 3 for a resident draw whose ids exceed the
row count (`idx_bound > n`, `draw_pallas.py:1164-1172`) and mode 2 for a
non-resident one, so no large grid is needed.

K1's words match bit for bit, and so does the sorted key stream (each
side's output rows looked up by their sorted ids). Mode 3 keys tie where
two ids share their low 19 bits and a tile, and neither package's sort is
stable there, so ids, cleaned positions and velocity words are compared by
identity, and the accumulators within the bf16-vs-f32 tolerance of
tests/test_torch_draw.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu.ops import draw_pallas as jdraw
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.ops import cuda_lib, draw_cuda as tdraw

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

GRID = (64, 384)
ROOT = 64
SPEED_LIMIT = 0.03
TIME = 160.0
FLOW_DECAY = 0.005
ID_BOUND = 1 << 24


def _case(seed=0):
    """A draw's inputs after a step (tests/test_torch_draw.py's), with
    unique ids spread over [0, 2^24), so the high bits are set, and a
    per-particle colour-map lookup."""
    rng = np.random.default_rng(seed)
    h, w = GRID
    n = ROOT * ROOT
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
        ids=rng.choice(ID_BOUND, n, replace=False).astype(np.int32),
        vs=vs, mapped=(rng.uniform(0.0, 1.5, (4, n))
                       * np.float32(0.4)).astype(np.float32),
        scalar_map=(np.asarray([0.2, 0.5, 0.8, 1.0], np.float32)
                    * np.float32(0.4)),
        base=np.asarray([1.0, 1.0, 1.0, 0.5], np.float32),
        flow_color=np.asarray([1.0, 1.0, 1.0, 0.04], np.float32),
        sin_decay=np.sin(np.float32(TIME) * np.float32(FLOW_DECAY)))


def _kw(c, resident):
    return dict(samples=2, flow_width=5.0, line_width=1.0, speed_alpha=1e-6,
                sin_decay=float(c["sin_decay"]), flow_decay=FLOW_DECAY,
                derive_p0=resident, raw_accum=True)


def _jax_draw(c, mode):
    """The JAX accumulate: mode 3 resident (ids, riding positions, scalar
    colours), mode 2 non-resident (p0 and rgba8 streams, row ids arange
    bounded beyond n). Returns (accum, ids_s, p1_s, ride_s or None)."""
    j = jnp.asarray
    resident = mode == 3
    n = c["ids"].size
    out = jdraw.fused_draw_accumulate(
        GRID, j(c["p0"]), j(c["p1"]), j(c["vel"]), j(c["pos"]),
        None if resident else j(c["mapped"]), j(c["live"]),
        jnp.float32(SPEED_LIMIT), jnp.float32(TIME),
        idx=j(c["ids"]) if resident else jnp.arange(n, dtype=jnp.int32),
        ride=[j(c["pos"][0]), j(c["pos"][1])] if resident else None,
        idx_bound=ID_BOUND if resident else 2 * n, base_color=j(c["base"]),
        flow_color=j(c["flow_color"]),
        view_size=j(c["vs"]) if resident else None,
        mapped_scalar=j(c["scalar_map"]) if resident else None,
        interpret=True, **_kw(c, resident))
    aux = out[2]
    ride = [np.asarray(r) for r in out[3]] if resident else None
    return np.asarray(out[0]), np.asarray(aux[0]), np.asarray(aux[2]), ride


def _torch_draw(c, mode):
    t = torch.as_tensor
    resident = mode == 3
    n = c["ids"].size
    accum, _, aux, ride_s = tdraw.fused_draw_accumulate(
        GRID, None if resident else t(c["p0"]), t(c["p1"]), t(c["vel"]),
        t(c["pos"]), None if resident else t(c["mapped"]), t(c["live"]),
        SPEED_LIMIT, TIME,
        idx=t(c["ids"]) if resident else torch.arange(n, dtype=torch.int32),
        ride=[t(c["pos"][0]), t(c["pos"][1])] if resident else None,
        idx_bound=ID_BOUND if resident else 2 * n, base_color=t(c["base"]),
        flow_color=t(c["flow_color"]),
        view_size=t(c["vs"]) if resident else None,
        mapped_scalar=t(c["scalar_map"]) if resident else None,
        **_kw(c, resident))
    return (accum.numpy(), aux[0].numpy(), aux[1].numpy(),
            None if ride_s is None else [r.numpy() for r in ride_s])


def _jax_pack(c, mode):
    """The JAX `_pack_kernel` in gather mode 2 or 3 through `pallas_call`
    (interpret mode), one block of all N rows: (keym, p0 or None, p1, vl,
    rgba)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    h, w = GRID
    hp, wp = jdraw._pad_dims(h, w)
    n = c["ids"].size
    emit_p0 = mode == 2
    tail = np.zeros(17, np.float32)
    if not emit_p0:
        tail[15:17] = c["vs"]
    scal = np.concatenate([
        np.asarray([SPEED_LIMIT, TIME, 5.0, 1.0, 1e-6, c["sin_decay"],
                    FLOW_DECAY], np.float32),
        c["base"], c["flow_color"], tail]).astype(np.float32)[None]
    j = jnp.asarray
    ids = c["ids"] if mode == 3 else np.arange(n, dtype=np.int32)
    ins = [j(scal), j(c["p0"][:, 0]), j(c["p0"][:, 1]), j(c["p1"][:, 0]),
           j(c["p1"][:, 1]), j(c["vel"][0]), j(c["vel"][1]), j(c["pos"][0]),
           j(c["pos"][1]), *(j(m) for m in c["mapped"]), j(c["live"]),
           j(ids)]
    spec = pl.BlockSpec((n,), lambda b: (b,))
    n_out = (5 if emit_p0 else 4) + (1 if mode == 2 else 0)
    outs = pl.pallas_call(
        functools.partial(jdraw._pack_kernel, tiles_x=wp // 256,
                          pscale=jdraw._pos_scale(hp, wp), h=h, w=w,
                          gather=mode, emit_p0=emit_p0, emit_rgba=True),
        grid=(1,),
        in_specs=[pl.BlockSpec((1, 32), lambda b: (0, 0),
                               memory_space=pltpu.SMEM)]
        + [spec] * (len(ins) - 1),
        out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.int32)] * n_out,
        interpret=True)(*ins)
    outs = [np.asarray(o) for o in outs]
    if mode == 2:
        np.testing.assert_array_equal(outs[-1], ids)  # the id stream
        outs = outs[:-1]
    return (outs[0], outs[1] if emit_p0 else None, *outs[-3:]), scal[0]


@pytest.mark.parametrize("mode", [2, 3])
def test_pack_modes_match_jax(mode):
    """K1's plain version in gather mode 2 (the tile alone, exact p0,
    rgba8) and mode 3 (`tile << 19 | id & (2^19 - 1)`, key_recon) against
    the JAX `_pack_kernel`: keys, p0, p1 and velocity words bit for bit."""
    c = _case()
    n = c["ids"].size
    (keym, p0, p1, vl, _), scal = _jax_pack(c, mode)
    t = torch.as_tensor
    cuda_lib.reset_counts()
    got = tdraw.pack(
        t(scal), t(c["p1"]), t(c["vel"]), t(c["live"]),
        t(c["ids"]) if mode == 3 else torch.arange(n, dtype=torch.int32),
        grid_hw=GRID, pscale=tdraw.pos_scale_for(GRID),
        p0_pix=t(c["p0"]) if mode == 2 else None, pos=t(c["pos"]),
        mapped=t(c["mapped"]), gather=mode)
    name = "pack_p0_rgba_g2" if mode == 2 else "pack_rgba_g3"
    assert cuda_lib.plain_calls[name] == 1
    np.testing.assert_array_equal(got[0].numpy(), keym)
    np.testing.assert_array_equal(got[1].numpy(), p1)
    np.testing.assert_array_equal(got[2].numpy(), vl)
    if mode == 2:
        np.testing.assert_array_equal(got[3].numpy(), p0)
    else:
        # The id's low bits share the word; the tile leads.
        assert (got[0].numpy() & ((1 << 19) - 1)
                == c["ids"] & ((1 << 19) - 1)).all()


@pytest.mark.parametrize("mode", [2, 3])
def test_draw_modes_match_jax(mode):
    """`fused_draw_accumulate` in gather mode 2 (non-resident) and 3
    (resident) against the JAX function."""
    c = _case()
    n = c["ids"].size
    ja, jids, jp1, jride = _jax_draw(c, mode)
    cuda_lib.reset_counts()
    ta, tids, tp1, tride = _torch_draw(c, mode)
    name = "pack_p0_rgba_g2" if mode == 2 else "pack_g3"
    assert cuda_lib.plain_calls[name] == 1
    ids = c["ids"] if mode == 3 else np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(np.sort(tids), np.sort(ids))
    np.testing.assert_array_equal(np.sort(jids[:n]), np.sort(ids))
    # The sorted key streams: each side's output rows, looked up by id in
    # K1's (bit-exact) keys, are the sorted keys, bit for bit.
    keym = tdraw.pack_plain(
        *_pack_args(c, mode), grid_hw=GRID,
        pscale=tdraw.pos_scale_for(GRID), gather=mode,
        **_pack_kw(c, mode))[0].numpy()
    row_of = np.empty(ID_BOUND if mode == 3 else n, np.int64)
    row_of[ids] = np.arange(n)
    want = np.sort(keym)
    np.testing.assert_array_equal(keym[row_of[tids]], want)
    np.testing.assert_array_equal(keym[row_of[jids[:n]]], want)
    # By identity: the p1 words, and on the resident stream the cleaned
    # positions and the velocity words.
    t_by, j_by = np.argsort(tids), np.argsort(jids[:n])
    np.testing.assert_array_equal(tp1[t_by], jp1[:n][j_by])
    if mode == 3:
        for k in range(3):
            np.testing.assert_array_equal(tride[k][t_by],
                                          jride[k][:n][j_by])
        # The cleaned positions: the inputs with their low bits cleared.
        for k, mask in ((0, ~3), (1, ~7)):
            clean = (c["pos"][k].view(np.int32) & mask).view(np.float32)
            np.testing.assert_array_equal(tride[k][t_by],
                                          clean[np.argsort(ids)])
    # The accumulator: bf16 matmul operands on the TPU side, f32 here.
    scale = np.abs(ja).reshape(ja.shape[0], -1).max(axis=1)
    assert (scale > 0).all()
    assert (np.abs(ta - ja) <= 1e-2 * scale[:, None, None]).all()
    mass = np.abs(ja).sum(axis=(1, 2))
    assert (np.abs(ta.sum(axis=(1, 2)) - ja.sum(axis=(1, 2)))
            <= 5e-3 * mass).all()


def _pack_args(c, mode):
    """K1's positional inputs as `fused_draw_accumulate` builds them."""
    t = torch.as_tensor
    n = c["ids"].size
    resident = mode == 3
    scal = tdraw._draw_scal(
        SPEED_LIMIT, TIME, 5.0, 1.0, 1e-6, float(c["sin_decay"]), FLOW_DECAY,
        t(c["base"]), t(c["flow_color"]),
        t(c["scalar_map"]) if resident else torch.zeros(4),
        t(c["vs"]) if resident else torch.zeros(2), torch.device("cpu"))
    return (scal, t(c["p1"]), t(c["vel"]), t(c["live"]),
            t(c["ids"]) if resident else torch.arange(n, dtype=torch.int32))


def _pack_kw(c, mode):
    t = torch.as_tensor
    if mode == 3:
        return {}
    return dict(p0_pix=t(c["p0"]), pos=t(c["pos"]), mapped=t(c["mapped"]))


def test_gather_mode_choice():
    """`gather_mode`, condition for condition as `draw_pallas.py:
    1154-1174`, at the configurations' sizes."""
    gm = tdraw.gather_mode
    c2, c3, c5 = (tdraw.seg_tile_count(g) for g in
                  ((1080, 1920), (1080, 1920), (2160, 3840)))
    assert c5 == 2484
    assert gm(1 << 20, c2, ids=True, resident=True, idx_bound=1 << 20) == 1
    assert gm(1 << 22, c3, ids=True, resident=True, idx_bound=1 << 22) == 3
    assert gm(1 << 24, c5, ids=True, resident=True, idx_bound=1 << 24) == 3
    assert gm(1 << 22, c3, ids=True, resident=False) == 2
    assert gm(1 << 24, c5, ids=True, resident=False) == 2
    assert gm(1 << 24, c5, ids=False, resident=True) == 0
    assert gm(1 << 20, c2, ids=True, resident=True, idx_bound=1 << 21) == 3
    assert gm(1 << 20, 4097, ids=True, resident=True) == 2
    assert gm(1 << 20, c2, ids=True, resident=True,
              idx_bound=(1 << 24) + 1) == 2
