"""The slice as a whole: the port's resident flow-feedback frame against the
JAX engine's (its Pallas kernels in interpret mode), from the same state.

Particles are compared by identity (`sim.idx` inverted on each side: a
one-ulp move may legitimately move a row in the sort), grids with the
reference's own cross-path tolerance (tests/test_fused_draw.py: the splat
sums bf16 products on the TPU side and f32 on the port's, which moves a
deposit by a texel fraction).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tendrils_tpu import engine as jengine
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine
from tendrils_tpu_torch.ops import cuda_lib

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
FRAMES = 3


def _arrays(sim):
    return {f.name: (None if getattr(sim, f.name) is None
                     else np.array(getattr(sim, f.name)))
            for f in dataclasses.fields(sim)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine spawned, then FRAMES facade frames: the state (numpy)
    and timer after each, plus a copy of the spawned state."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    sim0 = jax.tree_util.tree_map(jnp.array, eng.sim)
    snaps = [(_arrays(eng.sim), eng.timer.time)]
    for _ in range(FRAMES):
        eng.frame()
        snaps.append((_arrays(eng.sim), eng.timer.time))
    return eng, sim0, snaps


def _port(eng, snap):
    """A port facade on the CPU holding the JAX state `snap`."""
    arrays, time = snap
    t = tengine.Tendrils(convert.engine_config(eng.config), device="cpu")
    t.setup()
    t.sim = convert.sim_from_numpy(arrays)
    t.timer.time = time
    return t


def _smooth(img):
    k = np.ones(3) / 3
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -1, img)
    return np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -2, img)


def _compare(tsim, want):
    def by_id(rows, idx):
        return rows[:, np.argsort(idx)]

    got = convert.sim_to_numpy(tsim)
    np.testing.assert_array_equal(np.sort(got["idx"]),
                                  np.arange(got["idx"].size))
    for name in ("particles", "previous", "force"):
        np.testing.assert_allclose(by_id(got[name], got["idx"]),
                                   by_id(want[name], want["idx"]),
                                   atol=1e-4, err_msg=name)
    for name in ("flow", "view"):
        np.testing.assert_allclose(_smooth(got[name]), _smooth(want[name]),
                                   rtol=5e-2, atol=2e-2, err_msg=name)
        np.testing.assert_allclose(got[name].sum(), want[name].sum(),
                                   rtol=1e-3, err_msg=name)
    assert (got["particles"][0] > -9e5).any()
    assert (got["flow"][3] > 1e-3).any()


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
    _compare(tsim, _arrays(jsim))


def test_unported_branches_raise():
    cfg = tengine.EngineConfig(root_num=4, view_res=(16, 128))
    eng = tengine.Tendrils(cfg, device="cpu").setup()
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.spawn_shader(lambda p, e: p, target="targets")
    eng.state["flowWeight"] = 0.0
    with pytest.raises(NotImplementedError, match="flow_off"):
        eng.frame()
    eng.state["flowWeight"] = 1.0
    eng.state["lineWidth"] = 9.0
    with pytest.raises(NotImplementedError, match="KMAX_WIDTH"):
        eng.frame()
    eng.timer.paused = True
    with pytest.raises(NotImplementedError, match="paused draw"):
        eng.frame()
    classic = tengine.Tendrils(dataclasses.replace(cfg, resident_stream=False),
                               device="cpu").setup()
    with pytest.raises(NotImplementedError, match="non-resident"):
        classic.frame()
    with pytest.raises(NotImplementedError, match="non-resident"):
        classic.step_draw_io()
    # The interactive frame's unported stages, and K7.
    io = tengine.Tendrils(cfg, device="cpu").setup()
    with pytest.raises(NotImplementedError, match="colour maps.*item 7"):
        io.step_draw_io(color_maps=[np.ones((4, 2, 2), np.float32)],
                        color_alphas=[1.0])
    with pytest.raises(NotImplementedError, match="blur, bokeh.*item 9"):
        io.step_draw_io(blur=(3.0, 1.0))
    with pytest.raises(NotImplementedError, match="item 9"):
        io.step_draw_io(bokeh=(2.0, 0.5))
    with pytest.raises(NotImplementedError, match="K7.*item 7"):
        tengine.force_from_aux(io.sim.flow, (io.sim.idx, io.sim.idx),
                               io.params(), 0.0, cfg)
    with pytest.raises(NotImplementedError, match="want_eff"):
        tengine.draw_sim(io.sim, io.params(), 0.0, cfg, io._view_size,
                         want_aux=True, resident=True, targets_live=False,
                         stepped=True, fast_resolve=True, want_eff=True)
    # The xla splat backend (e.g. from a converted JAX config).
    seg = (np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32),
           np.full((2, 2), 0.01, np.float32))
    xla = tengine.Tendrils(dataclasses.replace(cfg, splat_backend="xla"),
                           device="cpu").setup()
    with pytest.raises(NotImplementedError, match="xla splat.*item 4"):
        xla.inject_flow_segments(*seg, 2.0)
    io.timer.paused = True
    with pytest.raises(NotImplementedError, match="paused io frame"):
        io.step_draw_io()
