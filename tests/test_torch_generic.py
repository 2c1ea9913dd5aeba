"""The generic draw and its flow variants: the port against the JAX
package, from the same states.

The generic draw (`engine._draw_generic`) runs where the fused draw does
not: `fused_draw=False`, the "xla" splat backend (the JAX package's
default) and a flow grid of its own (`flow_res`); `flow_levels > 1`
gathers from a flow pyramid. Each piece is held to its JAX function:
`splat.splat_accumulate_xla`, `render.particle_colors` (the JAX side
under `jax.disable_jit()`, as tests/test_torch_logic.py runs the noise,
so that XLA contracts no multiply-add), `engine.flow_pyramid` bit for
bit, `engine.step_sim` with the xla gather and with two levels, one
`engine.draw_sim` and the facade's entry points on four configurations.

Tolerances: "xla" against "xla", rtol 1e-5 / atol 1e-6 (the same f32
products, added in other orders); "kernel" (K9's and K5's plain
versions) against "pallas" (the JAX kernels in interpret mode), rtol 1e-4
/ atol 1e-4, the tolerance the JAX package holds its Pallas splat to
(tests/test_splat_pallas.py); facade frames (several frames of feedback)
by atol 1e-4 on the particles by identity and rtol 1e-4 / atol 1e-4 on
the grids. A grid's atol scales with a channel's largest |value| above 1
(`_grids_close`: the flow's stamp channel holds the time). The JAX
frames run jitted, as its own tests run them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, media as jmedia
from tendrils_tpu.ops import render as jrender, splat as jsplat
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine, flow_line
from tendrils_tpu_torch import media as tmedia
from tendrils_tpu_torch.ops import coords, cuda_lib, render as trender
from tendrils_tpu_torch.ops import spawn as tspawn, splat as tsplat
from test_torch_splat import _case
from torch_parity import port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

# tests/test_fused_draw.py's size, with several rows across each line.
CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=3,
           view_samples=2, view_rows=2)
# Port backend -> (the JAX backend, rtol, atol).
TOL = {"xla": ("xla", 1e-5, 1e-6), "kernel": ("pallas", 1e-4, 1e-4)}
FACADE_TOL = 1e-4
OF_U = {"offset": 0.05, "speed": 0.08}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's small tensors: beside other test
    workers, a thread pool per op only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _params(p):
    return convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _grids_close(got, want, rtol, atol, name):
    """`[..., 4, H, W]` grids within rtol and atol, the atol of each
    channel scaled by its largest |value| where that exceeds 1: where a
    texel's deposit is light, its composite weight 1 - exp(logt) cancels,
    so an ulp of exp (torch's and XLA's differ) moves the texel by ~1e-7
    of its channel's values, and the flow's stamp channel holds the time
    (~35 to ~150 here)."""
    got = got.reshape(-1, 4, *got.shape[-2:])
    want = want.reshape(got.shape)
    for c in range(4):
        scale = max(1.0, float(np.abs(want[:, c]).max()))
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=rtol,
                                   atol=atol * scale,
                                   err_msg=f"{name} channel {c}")


def test_jax_default_config_converts_to_xla():
    """The JAX package's default `EngineConfig()` becomes the port's
    xla/xla config, field for field, and takes the generic draw."""
    jcfg = jengine.EngineConfig()
    cfg = convert.engine_config(jcfg)
    assert (cfg.splat_backend, cfg.gather_backend) == ("xla", "xla")
    for f in dataclasses.fields(cfg):
        if f.name not in ("splat_backend", "gather_backend"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.fused_draw and cfg.flow_res is None and cfg.flow_levels == 1
    assert not tengine.fused_draw_ok(cfg)
    assert not tengine.carry_enabled(cfg)


@pytest.mark.parametrize("kind", ["dense", "sparse", "edges"])
def test_splat_accumulate_xla_matches_jax(kind):
    """The f32 scatter against the JAX xla backend, and K9's plain version
    (int64 sums) beside it: no kernel's plain version runs."""
    grid_hw, x, y, vals, alpha = _case(kind)
    cuda_lib.reset_counts()
    got = tsplat.splat_accumulate_xla(grid_hw, *map(_t, (x, y, vals, alpha)))
    assert not cuda_lib.plain_calls
    want = jsplat.splat_accumulate_xla(grid_hw, *map(jnp.asarray,
                                                     (x, y, vals, alpha)))
    for name, a, b in zip(("num", "wsum", "logt"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(a.numpy()).sum() > 0


@pytest.mark.parametrize("backend", list(TOL))
def test_splat_segments_accumulate_matches_jax(backend):
    """The segment splat's sums (3 rows across a 2.5 px width) on each
    backend against the JAX function on its counterpart, before any
    composite."""
    jback, rtol, atol = TOL[backend]
    rng = np.random.default_rng(8)
    h, w = 32, 128
    p0 = np.stack([rng.uniform(-3, w + 3, 80), rng.uniform(-3, h + 3, 80)],
                  axis=-1).astype(np.float32)
    p1 = p0 + rng.uniform(-6, 6, (80, 2)).astype(np.float32)
    vals = rng.uniform(-0.01, 0.01, (4, 80)).astype(np.float32)
    alpha = rng.uniform(0, 0.8, 80).astype(np.float32)
    kw = dict(grid_hw=(h, w), samples=2, rows=3)
    want = jsplat.splat_segments_accumulate(
        *map(jnp.asarray, (p0, p1, vals, alpha)), width=jnp.float32(2.5),
        backend=jback, **kw)
    got = tsplat.splat_segments_accumulate(
        *map(_t, (p0, p1, vals, alpha)), width=torch.tensor(2.5),
        backend=backend, **kw)
    for name, a, b in zip(("num", "wsum", "logt"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)
        assert np.abs(a.numpy()).sum() > 0


def test_splat_backends():
    """`backend=` picks the scatter or K9; an unknown name raises, as the
    JAX function's does."""
    rng = np.random.default_rng(3)
    p0 = _t(rng.uniform(0, 60, (20, 2)).astype(np.float32))
    p1 = p0 + 3.0
    vals = _t(rng.uniform(-0.01, 0.01, (4, 20)).astype(np.float32))
    alpha = _t(rng.uniform(0, 0.8, 20).astype(np.float32))
    kw = dict(grid_hw=(32, 64), width=2.0, samples=2, rows=3)
    cuda_lib.reset_counts()
    xla = tsplat.splat_segments_accumulate(p0, p1, vals, alpha,
                                           backend="xla", **kw)
    assert not cuda_lib.plain_calls
    kernel = tsplat.splat_segments_accumulate(p0, p1, vals, alpha,
                                              backend="kernel", **kw)
    assert cuda_lib.plain_calls["splat_points"] == 1
    for a, b in zip(xla, kernel):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown splat backend"):
        tsplat.splat_segments_accumulate(p0, p1, vals, alpha,
                                         backend="pallas", **kw)


def test_particle_colors_matches_jax():
    """The render colour model against the JAX function, with a textured
    colour map, live colours and a speedAlpha of 0 on a second call."""
    rng = np.random.default_rng(4)
    n = 500
    pos = rng.uniform(-1.2, 1.2, (2, n)).astype(np.float32)
    vel = rng.uniform(-0.02, 0.02, (2, n)).astype(np.float32)
    uv = rng.uniform(0, 1, (2, n)).astype(np.float32)
    cmap = rng.uniform(0, 1, (4, 8, 8)).astype(np.float32)
    params = {k: np.asarray(v) for k, v in jengine.default_params().items()}
    params["flowColor"] = np.float32([0.9, 0.3, 0.6, 0.7])
    params["baseColor"] = np.float32([0.2, 0.4, 0.1, 0.5])
    params["colorMapAlpha"] = np.float32(0.8)
    for speed_alpha in (params["speedAlpha"], np.float32(0.0)):
        params["speedAlpha"] = speed_alpha
        with jax.disable_jit():
            want = jrender.particle_colors(
                *map(jnp.asarray, (pos, vel, uv, cmap)),
                {k: jnp.asarray(v) for k, v in params.items()},
                jnp.float32(1234.5))
        got = trender.particle_colors(*map(_t, (pos, vel, uv, cmap)),
                                      _params(params), torch.tensor(1234.5))
        assert got.shape == (4, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        assert (got[3] > 0).any()


def test_flow_pyramid_matches_jax():
    """Each level the 2 x 2 mean of the one above, bit for bit; a level
    that cannot halve raises (the JAX `reshape` does)."""
    grid = np.random.default_rng(5).uniform(-1, 1, (4, 16, 32)).astype(
        np.float32)
    want = jengine.flow_pyramid(jnp.asarray(grid), 3)
    got = tengine.flow_pyramid(_t(grid), 3)
    assert [tuple(g.shape) for g in got] == [(4, 16, 32), (4, 8, 16),
                                             (4, 4, 8)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="cannot halve"):
        tengine.flow_pyramid(torch.zeros(4, 6, 10), 3)


@pytest.fixture(scope="module")
def start():
    """The JAX engine on xla/xla at CFG, spawned and run 2 frames: its
    config, state (numpy) and timer."""
    eng = jengine.Tendrils(jengine.EngineConfig(
        splat_backend="xla", gather_backend="xla", **CFG))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.frame()
    eng.frame()
    return eng.config, sim_arrays(eng.sim), eng.timer.time


def _jax_sim(arrays):
    return jengine.state_mod.SimState(**{
        k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("backend,levels", [("xla", 1), ("xla", 2),
                                            ("kernel", 2)])
def test_step_sim_matches_jax(start, backend, levels):
    """One step without a carried force: the xla gather (interpolate, then
    decay) and the kernel gather (decay, then K5 on each level), over one
    flow level or a pyramid of two."""
    cfg, arrays, t0 = start
    jback, rtol, atol = TOL[backend]
    jcfg = dataclasses.replace(cfg, gather_backend=jback, flow_levels=levels)
    jeng = jengine.Tendrils(jcfg)
    step = jax.jit(jengine.step_sim, static_argnames=("cfg", "flow_off"))
    want = step(_jax_sim(arrays), jeng.params(), jnp.float32(t0 + 16.0),
                jnp.float32(16.0), jcfg, jeng._view_size)
    teng = port_engine(jcfg, arrays, t0)
    cuda_lib.reset_counts()
    got = tengine.step_sim(teng.sim, teng.params(), torch.tensor(t0 + 16.0),
                           torch.tensor(16.0), teng.config, teng._view_size)
    assert cuda_lib.plain_calls["bilinear_gather"] == (
        levels if backend == "kernel" else 0)
    np.testing.assert_allclose(got.particles.numpy(),
                               np.asarray(want.particles), rtol=rtol,
                               atol=atol)
    assert not np.array_equal(got.particles.numpy(), arrays["particles"])


@pytest.mark.parametrize("backend,flow_res", [("xla", None),
                                              ("kernel", None),
                                              ("kernel", (16, 64))])
def test_draw_sim_matches_jax(start, backend, flow_res):
    """One generic draw (`fused_draw=False`): the flow pass (3 rows across
    flowWidth) and the view pass (2 rows across lineWidth), on a flow grid
    of the view's shape and of its own; K9's plain version twice on
    "kernel", no plain version on "xla"."""
    cfg, arrays, t0 = start
    jback, rtol, atol = TOL[backend]
    jcfg = dataclasses.replace(cfg, splat_backend=jback, fused_draw=False,
                               flow_res=flow_res)
    if flow_res is not None:
        # A flow grid of flow_res, painted with content of its own.
        arrays = dict(arrays, flow=np.random.default_rng(6).uniform(
            0, 0.01, (4, *flow_res)).astype(np.float32))
    jeng = jengine.Tendrils(jcfg)
    jeng.state["flowWidth"] = 2.5
    jeng.state["lineWidth"] = 1.5
    want = jax.jit(jengine.draw_sim, static_argnames=("cfg",))(
        _jax_sim(arrays), jeng.params(), jnp.float32(t0), jcfg,
        jeng._view_size)
    teng = port_engine(jcfg, arrays, t0)
    teng.state.update(flowWidth=2.5, lineWidth=1.5)
    cuda_lib.reset_counts()
    got = tengine.draw_sim(teng.sim, teng.params(), torch.tensor(t0),
                           teng.config, teng._view_size)
    assert dict(cuda_lib.plain_calls) == (
        {"splat_points": 2} if backend == "kernel" else {})
    for name in ("flow", "view"):
        _grids_close(getattr(got, name).numpy(),
                     np.asarray(getattr(want, name)), rtol, atol, name)
    assert not np.array_equal(got.view.numpy(), arrays["view"])


# --- the facade's entry points -----------------------------------------------

# name -> (JAX config fields at the test size, the view grid)
FACADE = {
    # The JAX package's default EngineConfig (xla/xla, 4 x 3 flow and 4 x 1
    # view samples), cut to 16^2 particles.
    "default-xla": dict(root_num=16, view_res=(32, 128)),
    "generic-kernel": dict(CFG, splat_backend="pallas",
                           gather_backend="pallas", fused_draw=False),
    # tests/test_engine.py:147-160's flow grid under a 48 x 64 view.
    "flow-res": dict(CFG, view_res=(48, 64), flow_res=(24, 32)),
    # tests/test_ops.py:252's two levels.
    "flow-levels-2": dict(CFG, flow_levels=2),
}


def _io_inputs(view_res, frames):
    """Per io frame: a u8 camera image (a bright bar moving right) and
    two pointers' segments."""
    h, w = view_res
    view_size = coords.cover_aspect((w, h))
    lines = flow_line.FlowLines()
    out = []
    for i in range(frames + 1):
        for p in range(2):
            a = 0.35 * i + np.pi * p
            lines.get(p).add(16.0 * i, (0.5 * np.cos(a), 0.45 * np.sin(a)))
        img = np.zeros((24, 64, 3), np.uint8)
        img[:, 6 * i + 10:6 * i + 20] = 255
        if i:
            out.append((img, lines.segments(0.0, view_size, (h, w))))
    return out


def _facade_run(eng, ring, io):
    """The entry points in turn on one facade: 2 `frame()`s, `step()` +
    `draw()`, `step_draw()`, 2 `step_draw_io()` with the camera and
    pointers, a paused `frame()` (the paused `draw()`) and
    `run_headless` for 2 steps. Returns the final state."""
    eng.frame()
    eng.frame()
    eng.timer.tick()
    eng.step()
    eng.draw()
    eng.timer.tick()
    eng.step_draw()
    for img, seg in io:
        ring.set_pixels(img)
        eng.timer.tick()
        eng.step_draw_io(segments=seg, of_frames=ring.device_buffers(),
                         of_uniforms=OF_U)
        ring.step()
    eng.timer.paused = True
    eng.frame()
    eng.timer.paused = False
    run = jengine.run_headless if isinstance(eng, jengine.Tendrils) \
        else tengine.run_headless
    return run(eng.sim, eng.params(), eng.config, eng._view_size,
               eng.timer.time, 1000.0 / 60.0, 2)


@pytest.mark.parametrize("name", list(FACADE))
def test_facade_frames_match_jax(name):
    """Each configuration through `frame`, `step`, `draw`, `step_draw`,
    `step_draw_io` (camera and pointers), the paused draw and
    `run_headless`, from one spawn on each side: particles by identity
    and both grids within FACADE_TOL of the JAX engine's."""
    jcfg = jengine.EngineConfig(**FACADE[name])
    jeng = jengine.Tendrils(jcfg)
    jeng.setup()
    jeng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    teng = port_engine(jcfg, sim_arrays(jeng.sim), jeng.timer.time)
    assert not tengine.carry_enabled(teng.config)
    io = _io_inputs(jcfg.view_res, 2)
    cuda_lib.reset_counts()
    want = _facade_run(jeng, jmedia.OpticalFlow(OF_U), io)
    got = _facade_run(teng, tmedia.OpticalFlow(OF_U, device="cpu"), io)
    assert teng.timer.time == jeng.timer.time
    kernel = teng.config.splat_backend == "kernel"
    calls = cuda_lib.plain_calls
    # 9 draws of 2 passes and the pointers' splat on 2 io frames; 8 steps,
    # each gathering its force (K5) on one level, or two.
    assert calls["splat_points"] == (2 * 9 + 2 if kernel else 0)
    assert calls["bilinear_gather"] == (8 * jcfg.flow_levels if kernel
                                        else 0)
    got, want = convert.sim_to_numpy(got), sim_arrays(want)
    assert got["force"] is None and want["force"] is None
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_allclose(got["particles"], want["particles"], rtol=0,
                               atol=FACADE_TOL)
    for grid in ("flow", "view"):
        _grids_close(got[grid], want[grid], FACADE_TOL, FACADE_TOL, grid)
    assert (got["particles"][0] > -9e5).any() and (got["flow"][3] > 1e-3).any()


# --- the port's fused draw against its generic paths ------------------------


def test_fused_matches_generic_paths():
    """tests/test_fused_draw.py:33-66 on the port: with unit line widths,
    one step + draw from one spawn on the fused kernel draw, the generic
    kernel draw and the generic xla draw; the fused quantises positions
    and values, so the grids agree after a 1-px smoothing, the flow's
    deposit mass within 1e-3."""
    outs = {}
    for name, (fused, backend) in {"fused": (True, "kernel"),
                                   "generic_kernel": (False, "kernel"),
                                   "generic_xla": (False, "xla")}.items():
        cfg = tengine.EngineConfig(root_num=16, view_res=(32, 128),
                                   flow_samples=2, flow_rows=1,
                                   view_samples=2, splat_backend=backend,
                                   fused_draw=fused)
        eng = tengine.Tendrils(cfg, device="cpu").setup()
        eng.state["flowWidth"] = 1.0
        eng.state["lineWidth"] = 1.0
        eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6,
                                                  0.01))
        params = eng.params()
        sim = tengine.step_sim(eng.sim, params, torch.tensor(16.0),
                               torch.tensor(16.0), eng.config,
                               eng._view_size)
        sim = tengine.draw_sim(sim, params, torch.tensor(16.0), eng.config,
                               eng._view_size)
        outs[name] = (sim.flow.numpy(), sim.view.numpy())

    def smooth(img):
        k = np.ones(3) / 3
        img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -1,
                                  img)
        return np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -2,
                                   img)

    for a, b in [("fused", "generic_kernel"), ("fused", "generic_xla")]:
        for i in range(2):
            np.testing.assert_allclose(smooth(outs[a][i]),
                                       smooth(outs[b][i]), rtol=5e-2,
                                       atol=2e-2)
    np.testing.assert_allclose(outs["fused"][0].sum(),
                               outs["generic_xla"][0].sum(), rtol=1e-3)
