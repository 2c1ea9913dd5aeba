"""Live targets on the port: a target spawn (`spawn_shader(target=
"targets")`) makes the targets buffer live, and from then on its xy rows
ride the resident draw's sort beside the positions and come back re-stacked
as `(tx, ty, 0, 0)` by K4 (`gather_reconstruct_p1`) or K6
(`reconstruct_resident`). Against the JAX package (its Pallas kernels in
interpret mode): the plain K4 and K6 with targets, resident facade frames,
`run_headless` with its default `targets_live=True`, and an io frame
(K6) from one converted state; within the port: resident against classic,
gather mode 3 and the merge reorder carrying the targets bit for bit, the
best-sample target spawn's outcomes, and the facade's view helpers and
`resize` against the JAX facade's.

The targets are a copy: wherever they ride, they are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine
from tendrils_tpu.ops import draw_pallas as jdraw, gather_pallas as jgather
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine
from tendrils_tpu_torch import spawners as tspawners
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.ops import cuda_lib, draw_cuda as tdraw
from tendrils_tpu_torch.ops import gather_cuda as tgather, spawn as tspawn
from tendrils_tpu_torch.ops.draw_cuda import pos_scale_for
from tendrils_tpu_torch.ops.reorder_cuda import MAXKEY
from tendrils_tpu_torch.ops.tile_geom import (HALF, PAD_LO_H, PAD_LO_W,
                                              TILE_H, TILE_W, pad_dims)
from torch_parity import compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
FRAMES = 3
TARGET = 0.05  # the seek weight, strong enough to move the particles


def _by_id(rows, idx):
    """Rows re-ordered to identity (original index) order."""
    return rows[:, np.argsort(idx)]


def _targets_by_id(sim):
    return _by_id(sim.targets.numpy(), sim.idx.numpy())


# --- K4 and K6 with targets --------------------------------------------------


def _streams(m, seed=1):
    rng = np.random.default_rng(seed)
    npx = rng.uniform(-1, 1, m).astype(np.float32)
    npy = rng.uniform(-1, 1, m).astype(np.float32)
    inert = rng.random(m) < 0.2
    npx[inert] = INERT
    npy[inert] = INERT
    qx, qy = rng.integers(0, HALF + 1, (2, m)).astype(np.int32)
    vl = ((~inert).astype(np.int32) << 30) + qy * (HALF + 1) + qx
    tx, ty = rng.uniform(-1.2, 1.2, (2, m)).astype(np.float32)
    tx[::9] = INERT  # inert targets ride too
    return npx, npy, vl, tx, ty


@pytest.mark.parametrize("m", [3000, 4096])
def test_reconstruct_targets_matches_jax(m):
    """K6 with targets (plain version) against the JAX
    `reconstruct_resident(tx=, ty=)` in interpret mode: the targets equal,
    the other outputs as without targets (tests/test_torch_draw.py's
    tolerance: XLA's CPU FMA in the q15 decode), and those equal to the
    port's own call without targets."""
    npx, npy, vl, tx, ty = _streams(m)
    sl = np.float32(0.01)
    t = torch.as_tensor
    cuda_lib.reset_counts()
    got = tdraw.reconstruct_resident(t(npx), t(npy), t(vl), t(sl), t(tx),
                                     t(ty))
    assert cuda_lib.plain_calls == {"reconstruct_resident_targets": 1}
    assert len(got) == 3
    jout = jdraw.reconstruct_resident(
        jnp.asarray(npx), jnp.asarray(npy), jnp.asarray(vl), sl,
        jnp.asarray(tx), jnp.asarray(ty), interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jout[2])[:, :m])
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.stack([tx, ty, 0 * tx, 0 * ty]))
    for a, b in zip(got[:2], jout[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :m],
                                   rtol=1e-6, atol=2 * 2.0 ** -24 * sl)
    bare = tdraw.reconstruct_resident(t(npx), t(npy), t(vl), t(sl))
    assert len(bare) == 2
    for a, b in zip(got[:2], bare):
        assert torch.equal(a, b)


def test_gather_reconstruct_targets_matches_jax():
    """K4 with targets (plain version) against the JAX
    `gather_reconstruct_p1(tx=, ty=)` in interpret mode: the targets
    equal; the force and state as tests/test_torch_gather.py holds them;
    K4 with targets == K8 + K6 with targets."""
    rng = np.random.default_rng(2)
    h, w = 32, 128
    m = 3000
    pscale = pos_scale_for((h, w))
    grid = rng.uniform(-1, 1, (2, h, w)).astype(np.float32)
    xq = np.rint(rng.uniform(PAD_LO_W - 2, PAD_LO_W + w + 2, m) * pscale)
    yq = np.rint(rng.uniform(PAD_LO_H - 2, PAD_LO_H + h + 2, m) * pscale)
    p1 = (yq.astype(np.int32) * (HALF + 1) + xq.astype(np.int32))
    inv_p = 1.0 / pscale
    xs = np.clip(xq * inv_p, PAD_LO_W + 0.5, PAD_LO_W + w - 0.5)
    ys = np.clip(yq * inv_p, PAD_LO_H + 0.5, PAD_LO_H + h - 0.5)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    keys = ((np.floor(ys - 0.5).astype(np.int32) // TILE_H) * tiles_x
            + np.floor(xs - 0.5).astype(np.int32) // TILE_W)
    npx, npy, vl, tx, ty = _streams(m, seed=3)
    sl = np.float32(0.01)
    jout = jgather.gather_reconstruct_p1(
        *(jnp.asarray(a) for a in (grid, p1, keys, npx, npy, vl)), sl,
        jnp.asarray(tx), jnp.asarray(ty), inv_p=inv_p, interpret=True)
    t = torch.as_tensor
    cuda_lib.reset_counts()
    got = tgather.gather_reconstruct_p1(t(grid), t(p1), t(npx), t(npy),
                                        t(vl), t(sl), t(tx), t(ty),
                                        inv_p=inv_p)
    assert cuda_lib.plain_calls == {"gather_reconstruct_targets": 1}
    assert len(got) == 4 and len(jout) == 4
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jout[3])[:, :m])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jout[0])[:, :m],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:3], jout[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :m],
                                   rtol=1e-6, atol=2 * 2.0 ** -24 * sl)
    k8 = tgather.bilinear_gather_keyed_p1(t(grid), t(p1), inv_p=inv_p)
    k6 = tdraw.reconstruct_resident(t(npx), t(npy), t(vl), t(sl), t(tx),
                                    t(ty))
    for a, b in zip(got, (k8, *k6)):
        assert torch.equal(a, b)


def test_targets_arguments_are_checked():
    """One of tx, ty alone is refused; a launch with targets counts under
    its own name."""
    tx = _streams(64)[3]
    t = torch.as_tensor
    with pytest.raises(ValueError, match="tx and ty"):
        tdraw.check_targets(t(tx), None, 64)
    assert tdraw.targets_counter("reconstruct_resident", None) \
        == "reconstruct_resident"
    assert tdraw.targets_counter("gather_reconstruct", t(tx)) \
        == "gather_reconstruct_targets"


# --- frames against the JAX engine -------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine spawned (ball), one frame, then a target spawn (a
    smaller ball, into the targets) with `target` set; then FRAMES facade
    frames with the targets riding. The state after the target spawn
    (numpy), its timer, and the state after the frames."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    eng.setup()
    eng.state["target"] = TARGET
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.frame()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.3, 0.005),
                     target="targets")
    assert eng._targets_live
    start = (sim_arrays(jax.tree_util.tree_map(jnp.array, eng.sim)),
             eng.timer.time)
    for _ in range(FRAMES):
        eng.frame()
    return eng, start, sim_arrays(eng.sim)


def _port_live(eng, start, **cfg_kw):
    t = port_engine(eng.config, *start, **cfg_kw)
    t.state["target"] = TARGET
    t._targets_live = True
    return t


def _check_targets(tsim, spawned, want=None):
    """The targets by identity: the spawned xy rows, bit for bit, and
    zeros below (K4's and K6's re-stack); equal to the JAX state's."""
    got = _targets_by_id(tsim)
    np.testing.assert_array_equal(got[:2], spawned[:2])
    assert (got[2:] == 0).all()
    if want is not None:
        np.testing.assert_array_equal(
            got, _by_id(want["targets"], want["idx"]))


def test_live_target_frames_match_jax(jax_run):
    """FRAMES facade frames on each side from the state right after the
    target spawn: particles, previous, force and grids as
    `torch_parity.compare` holds them, the targets exactly; K4 with
    targets once a frame and K4 without never."""
    eng, start, want = jax_run
    t = _port_live(eng, start)
    spawned = _by_id(start[0]["targets"], start[0]["idx"])
    assert (spawned[2:] != 0).any()  # the spawn's velocity rows
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        t.frame()
    assert cuda_lib.plain_calls["gather_reconstruct_targets"] == FRAMES
    assert cuda_lib.plain_calls["gather_reconstruct"] == 0
    compare(t.sim, want)
    _check_targets(t.sim, spawned, want)


def test_run_headless_default_rides_the_targets(jax_run):
    """`run_headless` with its defaults (`targets_live=True`) on the
    resident config, against the JAX function with its defaults."""
    eng, start, _ = jax_run
    sim0 = jax.tree_util.tree_map(jnp.asarray, dataclasses.replace(
        eng.sim, **{k: v for k, v in start[0].items()
                    if v is not None and k != "key"}))
    t0, dt = start[1], 1000.0 / 60.0
    params = dict(eng.params())
    jsim = jengine.run_headless(sim0, params, eng.config, eng._view_size,
                                jnp.float32(t0), dt, FRAMES,
                                fast_resolve=True)
    t = _port_live(eng, start)
    cuda_lib.reset_counts()
    tsim = tengine.run_headless(t.sim, t.params(), t.config, t._view_size,
                                t0, dt, FRAMES)
    assert cuda_lib.plain_calls["gather_reconstruct_targets"] == FRAMES
    want = sim_arrays(jsim)
    compare(tsim, want)
    _check_targets(tsim, _by_id(start[0]["targets"], start[0]["idx"]), want)


def test_io_frame_rides_the_targets_through_k6(jax_run):
    """An io frame with pointer segments (the flow edited after the draw,
    so the state is rebuilt by K6 with targets and the force gathered by
    K8) on each side from the state after the target spawn."""
    from tendrils_tpu_torch import flow_line
    from tendrils_tpu_torch.ops import coords
    eng, start, _ = jax_run
    jeng = jengine.Tendrils(eng.config)
    jeng.setup()
    jeng.state["target"] = TARGET
    jeng.sim = jax.tree_util.tree_map(jnp.asarray, dataclasses.replace(
        eng.sim, **{k: v for k, v in start[0].items()
                    if v is not None and k != "key"}))
    jeng.timer.time = start[1]
    jeng._targets_live = True
    t = _port_live(eng, start)
    h, w = CFG["view_res"]
    lines = flow_line.FlowLines()
    for i in range(3):
        lines.get(0).add(16.0 * i, (0.2 * i - 0.3, 0.1 * i))
    seg = lines.segments(0.0, coords.cover_aspect((w, h)), (h, w))
    cuda_lib.reset_counts()
    for e in (jeng, t):
        e.timer.tick()
        e.step_draw_io(segments=seg)
    assert cuda_lib.plain_calls["reconstruct_resident_targets"] == 1
    assert cuda_lib.plain_calls["reconstruct_resident"] == 0
    assert cuda_lib.plain_calls["gather_keyed_p1"] == 1
    want = sim_arrays(jeng.sim)
    compare(t.sim, want)
    _check_targets(t.sim, _by_id(start[0]["targets"], start[0]["idx"]),
                   want)


# --- within the port ---------------------------------------------------------


def _port(resident=True, root=16, **kw):
    cfg = tengine.EngineConfig(**dict(CFG, root_num=root,
                                      splat_backend="kernel",
                                      gather_backend="kernel",
                                      resident_stream=resident), **kw)
    eng = tengine.Tendrils(cfg, device="cpu").setup()
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    return eng


def _target_spawn(eng):
    eng.state["target"] = TARGET
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.3, 0.005),
                     target="targets")
    return _targets_by_id(eng.sim).copy()


def test_resident_matches_classic_with_targets():
    """After tests/test_resident_stream.py:91-111: a target spawn on a
    resident and a classic engine, FRAMES frames; the particles by
    identity within 5e-5 (the JAX test's bound), the targets' xy rows by
    identity within 1e-6 (here: equal), and the classic frames leave the
    targets, velocity rows included, as the spawn wrote them."""
    a, b = _port(True), _port(False)
    spawned = [_target_spawn(e) for e in (a, b)]
    np.testing.assert_array_equal(spawned[0], spawned[1])
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        a.frame()
        b.frame()
    assert cuda_lib.plain_calls["gather_reconstruct_targets"] == FRAMES
    np.testing.assert_allclose(_by_id(a.sim.particles.numpy(),
                                      a.sim.idx.numpy()),
                               b.sim.particles.numpy(), atol=5e-5)
    ta = _targets_by_id(a.sim)
    np.testing.assert_allclose(ta[:2], b.sim.targets.numpy()[:2], atol=1e-6)
    _check_targets(a.sim, spawned[0])
    np.testing.assert_array_equal(b.sim.targets.numpy(), spawned[1])


def test_inert_targets_pass_through():
    """Before any target spawn the targets do not ride: the buffer comes
    out of the frame as the same tensor, and K4 runs without targets."""
    a = _port(True)
    targets = a.sim.targets
    cuda_lib.reset_counts()
    a.frame()
    assert a.sim.targets is targets
    assert cuda_lib.plain_calls["gather_reconstruct"] == 1
    assert cuda_lib.plain_calls["gather_reconstruct_targets"] == 0


@pytest.mark.parametrize("mode", [1, 3])
def test_targets_cross_the_sort_bit_for_bit(mode):
    """`fused_draw_accumulate` with `ride=[x, y, tx, ty]` in gather mode 1
    and in mode 3 (forced as tests/test_torch_gather_modes.py forces it:
    ids bounded beyond n), against the JAX function: the sorted targets
    by identity equal the inputs bit for bit on both sides, the positions
    come back cleaned of the id bits in mode 3, and `ride_sorted` keeps
    the JAX layout `[x, y, tx, ty, vl]`."""
    rng = np.random.default_rng(mode)
    h, w = 64, 384
    n = 64 * 64
    bound = n if mode == 1 else 1 << 24
    vs = np.float32(max(h, w)) / np.asarray([w, h], np.float32)
    pos = (rng.uniform(-1.02, 1.02, (2, n)) / vs[:, None]).astype(np.float32)
    vel = (rng.uniform(-0.7, 0.7, (2, n)) * 0.03).astype(np.float32)
    dead = rng.random(n) < 0.1
    pos[:, dead] = INERT
    vel[:, dead] = 0.0
    p1 = np.stack([(pos[0] * vs[0] * np.float32(0.5) + np.float32(0.5)) * w,
                   (pos[1] * vs[1] * np.float32(0.5) + np.float32(0.5)) * h],
                  axis=-1).astype(np.float32)
    ids = (rng.permutation(n) if mode == 1 else
           rng.choice(bound, n, replace=False)).astype(np.int32)
    tx, ty = rng.uniform(-1.2, 1.2, (2, n)).astype(np.float32)
    live = (~dead).astype(np.float32)
    scal_map = np.float32([0.2, 0.5, 0.8, 1.0]) * np.float32(0.4)
    kw = dict(samples=2, flow_width=5.0, line_width=1.0, speed_alpha=1e-6,
              sin_decay=0.5, flow_decay=0.005, derive_p0=True, raw_accum=True,
              idx_bound=bound)
    j = jnp.asarray
    jout = jdraw.fused_draw_accumulate(
        (h, w), j(p1), j(p1), j(vel), j(pos), None, j(live),
        jnp.float32(0.03), jnp.float32(160.0), idx=j(ids),
        ride=[j(pos[0]), j(pos[1]), j(tx), j(ty)], view_size=j(vs),
        mapped_scalar=j(scal_map), interpret=True, **kw)
    t = torch.as_tensor
    cuda_lib.reset_counts()
    _, _, aux, ride_s = tdraw.fused_draw_accumulate(
        (h, w), None, t(p1), t(vel), t(pos), None, t(live), 0.03, 160.0,
        idx=t(ids), ride=[t(pos[0]), t(pos[1]), t(tx), t(ty)],
        view_size=t(vs), mapped_scalar=t(scal_map), **kw)
    assert cuda_lib.plain_calls["pack_g3" if mode == 3 else "pack"] == 1
    assert len(ride_s) == 5 and ride_s[-1].dtype == torch.int32
    order = np.argsort(ids)
    tids = aux[0].numpy()
    jids = np.asarray(jout[2][0])[:n]
    for side_ids, side_ride in ((tids, [r.numpy() for r in ride_s]),
                                (jids, [np.asarray(r)[:n]
                                        for r in jout[3]])):
        np.testing.assert_array_equal(np.sort(side_ids), ids[order])
        by = np.argsort(side_ids)
        np.testing.assert_array_equal(side_ride[2][by], tx[order])
        np.testing.assert_array_equal(side_ride[3][by], ty[order])
        for k, mask in ((0, ~3), (1, ~7)):
            clean = pos[k] if mode == 1 else (
                pos[k].view(np.int32) & mask).view(np.float32)
            np.testing.assert_array_equal(side_ride[k][by], clean[order])
    # The velocity words by identity: the same on both sides.
    np.testing.assert_array_equal(
        ride_s[4].numpy()[np.argsort(tids)],
        np.asarray(jout[3][4])[:n][np.argsort(jids)])


def test_merge_reorder_carries_the_targets():
    """The merge on (root 128, the smallest stream its gate admits): the
    targets follow the merge's `perm` as the positions do, bit for bit by
    identity, the merge engaged, and the particles as with the merge off
    (tests/test_torch_merge_engine.py's bounds)."""
    a = _port(True, root=128, merge_reorder=True)
    b = _port(True, root=128)
    assert tengine.merge_reorder_enabled(a.config)
    spawned = [_target_spawn(e) for e in (a, b)]
    cuda_lib.reset_counts()
    for _ in range(4):
        a.frame()
        b.frame()
    assert cuda_lib.events["reorder_merged"] >= 1
    assert cuda_lib.plain_calls["gather_reconstruct_targets"] == 8
    for eng, sp in zip((a, b), spawned):
        _check_targets(eng.sim, sp)
    pa = _by_id(a.sim.particles.numpy(), a.sim.idx.numpy())
    pb = _by_id(b.sim.particles.numpy(), b.sim.idx.numpy())
    np.testing.assert_allclose(pa, pb, atol=1e-3)
    assert (np.abs(pa - pb) > 5e-5).mean() < 0.01
    assert not torch.equal(a.sim.idx, b.sim.idx)


def test_best_sample_target_spawn_outcomes():
    """Trouble spot of the resident frame: its `previous` carries the
    current velocity (the reference package's documented deviation), and
    the best-sample target spawn scores `previous`, so rows cannot be
    compared one by one. As tests/test_resident_stream.py:114-147 does:
    the switch rate, the moments of the spawned positions and the mean
    speed agree between the resident and classic frames within 0.05."""
    img = np.asarray(np.random.RandomState(3).rand(4, 16, 32), np.float32)
    stats = {}
    for resident in (True, False):
        eng = _port(resident, root=32)
        for _ in range(2):
            eng.frame()
        before = eng.sim.previous.numpy().copy()
        parts = eng.sim.particles.clone()
        sp = tspawners.PixelSpawner(shader="best-sample", buffer=img,
                                    bias=1.2)
        sp.spawn(eng, target="targets")
        assert torch.equal(eng.sim.particles, parts)
        tg = eng.sim.targets.numpy()
        switched = (np.abs(tg[0] - before[0]) > 1e-6).mean()
        stats[resident] = (switched, tg[0].mean(), tg[1].mean(),
                           tg[0].std(), tg[1].std(),
                           np.hypot(tg[2], tg[3]).mean())
    np.testing.assert_allclose(stats[True], stats[False], atol=0.05)


def test_unknown_spawn_target_raises():
    eng = _port(True, root=4)
    with pytest.raises(ValueError, match="unknown spawn target"):
        eng.spawn_shader(lambda p, e: p, target="view")


# --- the facade's view helpers and resize ------------------------------------


def _facade_pair(num_view_buffers=2, **kw):
    cfg = jengine.EngineConfig(**dict(CFG, num_view_buffers=num_view_buffers,
                                      **kw))
    jeng = jengine.Tendrils(cfg)
    jeng.setup()
    rng = np.random.default_rng(9)
    view = rng.uniform(0, 1, jeng.sim.view.shape).astype(np.float32)
    jeng.sim = dataclasses.replace(jeng.sim, view=jnp.asarray(view))
    t = port_engine(cfg, sim_arrays(jeng.sim), jeng.timer.time)
    return jeng, t


def test_view_helpers_match_jax():
    """`draw_fade`, `copy_buffer`, `draw_buffer` and `step_buffers` on a
    ring of 2 view buffers, step for step against the JAX facade's."""
    jeng, t = _facade_pair()
    jeng.state["fadeColor"] = t.state["fadeColor"] = [0.1, 0.2, 0.3, 0.25]

    def same(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)

    same(t.copy_buffer(1), jeng.copy_buffer(1))
    same(t.copy_buffer(2), jeng.copy_buffer(2))  # past the ring: zeros
    assert not t.copy_buffer(2).any()
    before = t.sim.view.clone()
    t.step_buffers()
    jeng.step_buffers()
    assert torch.equal(t.sim.view[0], before[1])
    assert torch.equal(t.sim.view[1], before[0])
    t.draw_fade()
    jeng.draw_fade()
    same(t.sim.view, jeng.sim.view)
    assert torch.equal(t.sim.view[1], before[0])  # only buffer 0 fades
    same(t.draw_buffer(0), jeng.draw_buffer(0))
    same(t.sim.view, jeng.sim.view)


def test_step_buffers_single_buffer_is_a_no_op():
    jeng, t = _facade_pair(num_view_buffers=1)
    view = t.sim.view
    t.step_buffers()
    assert t.sim.view is view


@pytest.mark.parametrize("merge", [False, True])
def test_resize_matches_jax(merge):
    """`resize` on both facades: the config and view size, zeroed view
    and flow grids of the new shapes, the particles kept, the carried
    force dropped, the merge carry re-seeded for the new tile count (or
    none), the targets no longer live; then a frame on the port at the
    new size and one back at the old, live and finite."""
    kw = dict(root_num=128, merge_reorder=True) if merge else {}
    jeng, t = _facade_pair(num_view_buffers=1, **kw)
    t.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    t.frame()
    t._targets_live = True
    assert t.sim.force is not None
    parts = t.sim.particles.clone()
    for e in (jeng, t):
        e.resize((48, 256))
    assert t.config == convert.engine_config(jeng.config)
    np.testing.assert_array_equal(t._view_size.numpy(),
                                  np.asarray(jeng._view_size))
    assert not t._targets_live and not jeng._targets_live
    assert t.sim.view.shape == jeng.sim.view.shape == (1, 4, 48, 256)
    assert t.sim.flow.shape == jeng.sim.flow.shape == (4, 48, 256)
    assert not t.sim.view.any() and not t.sim.flow.any()
    assert t.sim.force is None and jeng.sim.force is None
    assert torch.equal(t.sim.particles, parts)
    if merge:
        for sim in (t.sim, jeng.sim):
            key, hist = np.asarray(sim.sort_key), np.asarray(sim.sort_hist)
            assert (key == MAXKEY).all() and not hist.any()
            assert hist.shape == (tdraw.seg_tile_count((48, 256)),)
    else:
        assert t.sim.sort_key is None and jeng.sim.sort_key is None
    for res in ((48, 256), CFG["view_res"]):
        if res != (48, 256):
            t.resize(res)
        t.frame()
        sim = t.sim
        assert sim.view.shape[-2:] == res
        assert all(torch.isfinite(getattr(sim, k)).all()
                   for k in ("particles", "previous", "flow", "view"))
        assert (sim.particles[0] > -9e5).any() and (sim.flow[3] > 1e-3).any()
