"""The slice as a whole: the port's resident flow-feedback frame against the
JAX engine's (its Pallas kernels in interpret mode), from the same state,
with a 1x1 and a textured colour map; the non-resident force gather; the
branch still to port, and the generic draw and xla splat that once
raised. The comparison is `torch_parity.compare`.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, state as jstate
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine
from tendrils_tpu_torch.ops import cuda_lib, spawn as tspawn
from torch_parity import compare as _compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
FRAMES = 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine spawned, then FRAMES facade frames: the state (numpy)
    and timer after each, plus a copy of the spawned state."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    sim0 = jax.tree_util.tree_map(jnp.array, eng.sim)
    snaps = [(sim_arrays(eng.sim), eng.timer.time)]
    for _ in range(FRAMES):
        eng.frame()
        snaps.append((sim_arrays(eng.sim), eng.timer.time))
    return eng, sim0, snaps


def _port(eng, snap):
    """A port facade on the CPU holding the JAX state `snap`."""
    return port_engine(eng.config, *snap)


def test_one_frame_from_converted_state(jax_run):
    """(a) The JAX state after 2 frames (carried force included), one frame
    on each side."""
    eng, _, snaps = jax_run
    t = _port(eng, snaps[FRAMES - 1])
    assert t.sim.force is not None
    cuda_lib.reset_counts()
    t.frame()
    assert t.timer.time == snaps[FRAMES][1]
    _compare(t.sim, snaps[FRAMES][0])
    # The carried force was used: no in-step gather ran.
    assert cuda_lib.plain_calls["bilinear_gather"] == 0
    assert cuda_lib.plain_calls["gather_reconstruct"] == 1


def test_facade_frames_from_spawn(jax_run):
    """(b) FRAMES facade frames from the same spawn; the first gathers its
    force in the step (K5), the rest use the carried force (K4)."""
    eng, _, snaps = jax_run
    t = _port(eng, snaps[0])
    assert t.sim.force is None
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        t.frame()
    assert cuda_lib.plain_calls["bilinear_gather"] == 1
    assert cuda_lib.plain_calls["pack"] == FRAMES
    _compare(t.sim, snaps[FRAMES][0])


def test_run_headless_from_spawn(jax_run):
    """(b) `run_headless` for FRAMES steps from the same spawn (the force
    seeded by `initial_force`, K5)."""
    eng, sim0, snaps = jax_run
    t0, dt = snaps[0][1], 1000.0 / 60.0
    jsim = jengine.run_headless(sim0, eng.params(), eng.config,
                                eng._view_size, jnp.float32(t0), dt, FRAMES,
                                targets_live=False, fast_resolve=True)
    t = _port(eng, snaps[0])
    tsim = tengine.run_headless(t.sim, t.params(), t.config, t._view_size,
                                t0, dt, FRAMES, targets_live=False)
    _compare(tsim, sim_arrays(jsim))


def test_draw_then_step_after_a_decay_change(jax_run):
    """A host change of flowDecay, then a direct `draw()`, then `step()`:
    `draw()` gathers the next force (K7) but does not re-key it, so the
    step drops it and gathers its own with the new decay (K5), as the JAX
    facade's `draw()` and `step()` do."""
    eng, _, snaps = jax_run
    arrays, time = snaps[FRAMES - 1]
    jeng = jengine.Tendrils(eng.config)
    jeng.setup()
    jeng.sim = jstate.SimState(**{k: None if v is None else jnp.asarray(v)
                                  for k, v in arrays.items()})
    jeng.timer.time = time
    t = _port(eng, snaps[FRAMES - 1])
    for e in (jeng, t):
        e._check_force_params()  # keyed to the decay the force was made at
        e.state["flowDecay"] = 2.0 * float(e.state["flowDecay"])
        e.draw()
    assert t.sim.force is not None
    cuda_lib.reset_counts()
    jeng.step()
    t.step()
    assert cuda_lib.plain_calls["bilinear_gather"] == 1
    _compare(t.sim, sim_arrays(jeng.sim))


@pytest.mark.parametrize("with_config", [False, True])
def test_facade_takes_the_seed(with_config):
    """`seed` is the JAX facade's keyword, with a config and without one:
    kept, seeding the facade's generator, and no config field."""
    cfg = tengine.EngineConfig(root_num=4, view_res=(16, 128))
    args = (cfg,) if with_config else ()
    kw = {} if with_config else dict(root_num=4, view_res=(16, 128))
    eng = tengine.Tendrils(*args, seed=3, device="cpu", **kw).setup()
    jeng = jengine.Tendrils(*args, seed=3, **kw)
    assert eng.seed == jeng.seed == 3
    assert eng.config == cfg
    assert eng.generator.initial_seed() == 3
    assert eng.sim.particles.shape == (4, 16)


def test_facades_with_one_seed_draw_the_same_numbers():
    a, b, c = (tengine.Tendrils(seed=s, device="cpu") for s in (5, 5, 6))
    draws = [torch.rand(64, generator=e.generator) for e in (a, b, c)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_unported_branches_raise():
    """No branch is left unported: the sharded draw (ROADMAP item 12), the
    last one that raised, runs, and no module of the package raises a
    not-ported error any more. `axis_name` takes the sum over the ranks;
    with one rank's (the identity) the fused and the generic draw are the
    unsharded draws bit for bit."""
    package = pathlib.Path(tengine.__file__).parent
    assert not [p for p in package.rglob("*.py")
                if "not_ported" in p.read_text()]
    for fused in (True, False):
        cfg = tengine.EngineConfig(root_num=4, view_res=(16, 128),
                                   fused_draw=fused)
        eng = tengine.Tendrils(cfg, device="cpu").setup()
        eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
        eng.step()
        t = torch.tensor(16.0)
        one = tengine.draw_sim(eng.sim, eng.params(), t, cfg,
                               eng._view_size)
        ranks = tengine.draw_sim(eng.sim, eng.params(), t, cfg,
                                 eng._view_size, axis_name=lambda x: x)
        assert (one.flow[3] > 0).any()
        for name in ("flow", "view"):
            assert torch.equal(getattr(one, name), getattr(ranks, name))


def test_generic_draw_runs():
    """`fused_draw=False` runs the generic draw (K9's plain version twice
    a frame on CPU tensors, K5's and K13's once a step), where it once
    raised."""
    cfg = tengine.EngineConfig(root_num=4, view_res=(16, 128),
                               fused_draw=False)
    eng = tengine.Tendrils(cfg, device="cpu").setup()
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    cuda_lib.reset_counts()
    eng.frame()
    assert dict(cuda_lib.plain_calls) == {"bilinear_gather": 1,
                                          "splat_points": 2,
                                          "logic_step": 1}
    assert (eng.sim.flow[3] > 0).any() and (eng.sim.view[0, 3] > 0).any()


def test_xla_splat_backend_injects():
    """The xla splat backend (a converted JAX default config) paints
    pointer segments with its f32 scatter, no kernel's plain version,
    where it once raised."""
    cfg = tengine.EngineConfig(root_num=4, view_res=(16, 128),
                               splat_backend="xla")
    seg = (np.asarray([[10.0, 8.0], [40.0, 5.0]], np.float32),
           np.asarray([[14.0, 8.0], [44.0, 9.0]], np.float32),
           np.full((2, 2), 0.01, np.float32))
    xla = tengine.Tendrils(cfg, device="cpu").setup()
    cuda_lib.reset_counts()
    xla.inject_flow_segments(*seg, 2.0)
    assert not cuda_lib.plain_calls
    kernel = tengine.Tendrils(dataclasses.replace(cfg, splat_backend="kernel"),
                              device="cpu").setup()
    kernel.inject_flow_segments(*seg, 2.0)
    assert cuda_lib.plain_calls["splat_points"] == 1
    assert (xla.sim.flow[3] > 0).any()
    torch.testing.assert_close(xla.sim.flow, kernel.sim.flow, rtol=1e-5,
                               atol=1e-6)


def test_resident_frame_with_textured_colour_map(jax_run):
    """The resident frame with a textured colour map (`set_color_map`):
    p0 re-derived (key_recon) but colours packed to rgba8 by K1 from the
    per-particle lookup, read by K2; the force gathered with K4."""
    eng, sim0, _ = jax_run
    cmap = np.random.default_rng(11).uniform(0, 1, (4, 8, 8)).astype(
        np.float32)
    jeng = jengine.Tendrils(eng.config)
    jeng.setup()
    jeng.sim = jax.tree_util.tree_map(jnp.array, sim0)
    t = _port(eng, (sim_arrays(sim0), jeng.timer.time))
    jeng.set_color_map(cmap)
    t.set_color_map(cmap)
    assert t.config.color_map_res == jeng.config.color_map_res == (8, 8)
    cuda_lib.reset_counts()
    for _ in range(2):
        jeng.frame()
        t.frame()
    calls = cuda_lib.plain_calls
    assert calls["pack_rgba"] == calls["splat_rgba"] == 2
    assert calls["gather_reconstruct"] == 2 and calls["pack"] == 0
    _compare(t.sim, sim_arrays(jeng.sim))


def test_force_from_aux_unsort_matches_jax():
    """`force_from_aux(unsort=True)`: K7 at the sorted p1 words, the scatter
    back to row order by the unique row ids, the q15 decode; within one
    q15 step (2 speedLimit / HALF) of the JAX function's."""
    from tendrils_tpu_torch.ops.draw_cuda import pos_scale_for
    from tendrils_tpu_torch.ops.tile_geom import (HALF, PAD_LO_H, PAD_LO_W,
                                                  TILE_H, TILE_W, pad_dims)
    rng = np.random.default_rng(12)
    cfg = tengine.EngineConfig(**dict(CFG, splat_backend="kernel",
                                      gather_backend="kernel",
                                      resident_stream=False))
    h, w = cfg.view_res
    n = cfg.n
    sl = np.float32(0.01)
    flow = np.stack([rng.uniform(-1.2, 1.2, (h, w)) * sl,
                     rng.uniform(-1.2, 1.2, (h, w)) * sl,
                     rng.uniform(0.0, 100.0, (h, w)),
                     rng.uniform(0.0, 1.0, (h, w))]).astype(np.float32)
    pscale = pos_scale_for((h, w))
    xq = np.rint(rng.uniform(PAD_LO_W - 2, PAD_LO_W + w + 2, n) * pscale)
    yq = np.rint(rng.uniform(PAD_LO_H - 2, PAD_LO_H + h + 2, n) * pscale)
    p1 = (yq.astype(np.int32) * (HALF + 1) + xq.astype(np.int32))
    xs = np.clip(xq / pscale, PAD_LO_W + 0.5, PAD_LO_W + w - 0.5)
    ys = np.clip(yq / pscale, PAD_LO_H + 0.5, PAD_LO_H + h - 0.5)
    tiles_x = pad_dims(h, w)[1] // TILE_W
    keys = ((np.floor(ys - 0.5).astype(np.int32) // TILE_H) * tiles_x
            + np.floor(xs - 0.5).astype(np.int32) // TILE_W)
    order = np.argsort(keys, kind="stable")
    ids = rng.permutation(n).astype(np.int32)[order]
    p1, keys = p1[order], keys[order]
    params = {"speedLimit": sl, "flowDecay": np.float32(0.005)}
    jforce = jengine.force_from_aux(
        jnp.asarray(flow), tuple(jnp.asarray(a) for a in (ids, keys, p1)),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32(90.0),
        jengine.EngineConfig(**dict(CFG, resident_stream=False)))
    cuda_lib.reset_counts()
    tforce = tengine.force_from_aux(
        torch.as_tensor(flow), (torch.as_tensor(ids), torch.as_tensor(p1)),
        convert.params_from_numpy(params, device="cpu"), torch.tensor(90.0),
        cfg)
    assert cuda_lib.plain_calls["gather_keyed_q15"] == 1
    assert tforce.shape == (2, n)
    np.testing.assert_allclose(tforce.numpy(), np.asarray(jforce),
                               rtol=0, atol=2 * sl / HALF * 1.001)
    assert np.abs(tforce.numpy()).max() == pytest.approx(sl)


@pytest.mark.parametrize("level", [0, 1])
def test_quality_tier_matches_jax(level):
    """`models.quality_tier`: the reference's rootNum x {1, 2, 4} tiers with
    damping nudged down per tier, as the JAX function builds them (the
    engines' configs and state at a small view)."""
    from tendrils_tpu.models import configs as jconfigs
    from tendrils_tpu_torch import models
    t = models.quality_tier(level, view_res=(16, 128), device="cpu")
    j = jconfigs.quality_tier(level, view_res=(16, 128))
    # Off the TPU the JAX zoo picks its "xla" backends; the port's are its
    # kernels (the JAX package's "pallas").
    assert t.config == dataclasses.replace(
        convert.engine_config(j.config), splat_backend="kernel",
        gather_backend="kernel")
    assert t.config.root_num == 512 * 2 ** level
    assert t.state["damping"] == pytest.approx(j.state["damping"], abs=0)
    assert ((t.sim.particles[0] > -9e5).sum().item()
            == int((np.asarray(j.sim.particles[0]) > -9e5).sum()))
