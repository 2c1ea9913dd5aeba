"""The classic carried-force frame (`resident_stream=False`) and the paused
draw against the JAX engine's (its Pallas kernels in interpret mode), from
one converted spawn: the draw keeps the row order and sends the exact p0
and rgba8 streams, and the next force is gathered with K7 and un-sorted by
row id. The comparison is `torch_parity.compare`.
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
from torch_parity import compare as _compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
FRAMES = 3


def _port(eng, snap):
    """A port facade on the CPU holding the JAX state `snap`."""
    return port_engine(eng.config, *snap)


CLASSIC = dict(CFG, resident_stream=False)


@pytest.fixture(scope="module")
def classic_run():
    """The JAX engine with the classic frame (`resident_stream=False`):
    spawned, FRAMES frames, then one frame with the timer paused (the
    paused draw); the state and timer after each, and the spawned state."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CLASSIC))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    sim0 = jax.tree_util.tree_map(jnp.array, eng.sim)
    snaps = [(sim_arrays(eng.sim), eng.timer.time)]
    for _ in range(FRAMES):
        eng.frame()
        snaps.append((sim_arrays(eng.sim), eng.timer.time))
    eng.timer.paused = True
    eng.frame()
    snaps.append((sim_arrays(eng.sim), eng.timer.time))
    return eng, sim0, snaps


def test_classic_frames_from_spawn(classic_run):
    """FRAMES classic frames from one converted spawn: the first gathers
    its force in the step (K5), every frame packs the exact p0 and rgba8
    streams (K1, K2), resolves with K3, and gathers the next force with
    K7 from K3's decayed flow, un-sorted by row id (q15: one step of
    2 speedLimit / HALF, far inside `_compare`'s atol)."""
    eng, _, snaps = classic_run
    t = _port(eng, snaps[0])
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        t.frame()
    calls = cuda_lib.plain_calls
    assert calls["bilinear_gather"] == 1
    assert calls["pack_p0_rgba"] == calls["splat_p0_rgba"] == FRAMES
    assert calls["resolve"] == calls["gather_keyed_q15"] == FRAMES
    assert calls["gather_reconstruct"] == calls["pack"] == 0
    # Rows keep their order.
    np.testing.assert_array_equal(t.sim.idx.numpy(), np.arange(t.config.n))
    _compare(t.sim, snaps[FRAMES][0])


def test_paused_frame_draws_and_gathers(classic_run):
    """The paused `frame()` is `draw()`: no step, the exact p0 stream, the
    XLA resolve tail, and the carried force gathered with K7 from the
    flow decayed to time + dt."""
    eng, _, snaps = classic_run
    t = _port(eng, snaps[FRAMES])
    t.timer.paused = True
    cuda_lib.reset_counts()
    t.frame()
    calls = cuda_lib.plain_calls
    assert calls["pack_p0_rgba"] == calls["splat_p0_rgba"] == 1
    assert calls["gather_keyed_q15"] == 1
    assert calls["resolve"] == calls["bilinear_gather"] == 0
    assert t.timer.time == snaps[FRAMES + 1][1]
    _compare(t.sim, snaps[FRAMES + 1][0])


@pytest.mark.parametrize("carry", [True, False],
                         ids=["classic", "no-carry"])
def test_run_headless_classic_and_no_carry(classic_run, carry):
    """`run_headless` for FRAMES steps from the same spawn: the classic
    frame (K7 each frame), and without the carried force (each step
    gathers its own with K5; the draw sends no row ids)."""
    eng, sim0, snaps = classic_run
    cfg = dataclasses.replace(eng.config, carry_force=carry)
    t0, dt = snaps[0][1], 1000.0 / 60.0
    jsim = jengine.run_headless(sim0, eng.params(), cfg, eng._view_size,
                                jnp.float32(t0), dt, FRAMES,
                                targets_live=False, fast_resolve=True)
    t = _port(eng, snaps[0])
    cuda_lib.reset_counts()
    tsim = tengine.run_headless(t.sim, t.params(),
                                convert.engine_config(cfg), t._view_size,
                                t0, dt, FRAMES, targets_live=False)
    calls = cuda_lib.plain_calls
    assert calls["gather_keyed_q15"] == (FRAMES if carry else 0)
    assert calls["bilinear_gather"] == (1 if carry else FRAMES)
    assert calls["pack_p0_rgba"] == FRAMES
    _compare(tsim, sim_arrays(jsim))
