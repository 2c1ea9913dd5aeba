"""The interactive frame as a whole: the port's `Tendrils.step_draw_io`
(pointer flow lines through K9, the camera's optical flow, the resident
draw with K6 and the K8 gather from the final flow) against the JAX
engine's (its Pallas kernels in interpret mode), from one converted state,
and the facade's `inject_flow_segments` + `composite_flow` + `frame()`.

Particles are compared by identity and grids with the reference's own
cross-path tolerance, as in tests/test_torch_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, media as jmedia
from tendrils_tpu.ops import optical_flow as jof, spawn as jspawn
from tendrils_tpu_torch import engine as tengine, flow_line
from tendrils_tpu_torch import media as tmedia
from tendrils_tpu_torch.ops import coords, cuda_lib
from tendrils_tpu_torch.ops import optical_flow as tof
from torch_parity import compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
CAM = (24, 64)  # camera frames (H, W), upsampled to the flow grid
FRAMES = 3
OF_U = {"offset": 0.05, "speed": 0.08}


@pytest.fixture(scope="module")
def start():
    """The JAX engine spawned and run 2 frames (a carried force), its
    state, timer and config."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.frame()
    eng.frame()
    return eng.config, jax.tree_util.tree_map(jnp.array, eng.sim), \
        eng.timer.time


def _inputs():
    """Per frame: a u8 camera image (a bright bar moving right) and the
    segments of two pointers moving on circles (5 crest rows each)."""
    h, w = CFG["view_res"]
    view_size = coords.cover_aspect((w, h))
    lines = flow_line.FlowLines()
    out = []
    for i in range(FRAMES + 1):
        for p in range(2):
            a = 0.35 * i + np.pi * p
            lines.get(p).add(16.0 * i, (0.5 * np.cos(a), 0.45 * np.sin(a)))
        img = np.zeros((*CAM, 3), np.uint8)
        img[:, 6 * i + 10:6 * i + 20] = 255
        if i:
            out.append((img, lines.segments(0.0, view_size, (h, w))))
    return out


def _jax_engine(start, **cfg_kw):
    cfg, sim0, t0 = start
    eng = jengine.Tendrils(dataclasses.replace(cfg, **cfg_kw))
    eng.setup()
    eng.sim = jax.tree_util.tree_map(jnp.array, sim0)
    eng.timer.time = t0
    return eng


def _port_engine(start, **cfg_kw):
    cfg, sim0, t0 = start
    return port_engine(cfg, sim_arrays(sim0), t0, **cfg_kw)


def _compare(tsim, want):
    # The camera's payload velocities reach ~500x speedLimit (the
    # reference's unclamped t² falloff), and the next draw blends them by a
    # transmittance the TPU sums from bf16 matmul operands
    # (draw_pallas.py:464,473): ~5e-4 of the flow, hence of the force
    # gathered from it.
    compare(tsim, want, force_rtol=2e-3)


@pytest.mark.parametrize("seg_on,of_on", [(True, True), (False, True),
                                          (True, False), (False, False)],
                         ids=["segments+optical-flow", "optical-flow",
                              "segments", "neither"])
def test_io_frames_match_jax(start, seg_on, of_on):
    """FRAMES io frames on each side from the same state: (a) segments and
    optical flow, (b) optical flow only, (c) segments only, (d) neither,
    which takes the fused K4 path as the JAX frame does."""
    jeng, teng = _jax_engine(start), _port_engine(start)
    assert teng.sim.force is not None
    jring = jmedia.OpticalFlow(OF_U)
    tring = tmedia.OpticalFlow(OF_U, device="cpu")
    cuda_lib.reset_counts()
    for img, seg in _inputs():
        for eng, ring in ((jeng, jring), (teng, tring)):
            ring.set_pixels(img)
            eng.timer.tick()
            assert eng.step_draw_io(
                segments=seg if seg_on else None,
                of_frames=ring.device_buffers() if of_on else None,
                of_uniforms=OF_U) is None
            ring.step()
    assert teng.timer.time == jeng.timer.time
    _compare(teng.sim, sim_arrays(jeng.sim))
    # Which force path ran: with flow edits the draw reassembles the state
    # alone (K6) and the force is gathered from the final flow (K8).
    calls = cuda_lib.plain_calls
    edits = seg_on or of_on
    assert calls["pack"] == calls["splat"] == calls["resolve"] == FRAMES
    assert calls["gather_reconstruct"] == (0 if edits else FRAMES)
    assert calls["reconstruct_resident"] == (FRAMES if edits else 0)
    assert calls["gather_keyed_p1"] == (FRAMES if edits else 0)
    assert calls["splat_points"] == (FRAMES if seg_on else 0)
    assert calls["bilinear_gather"] == 0


def test_facade_inject_composite_frame(start):
    """`inject_flow_segments` + `composite_flow` (a camera payload
    upsampled to the flow grid) drop the carried force, so the next
    `frame()` gathers it in the step (K5)."""
    jeng, teng = _jax_engine(start), _port_engine(start)
    (img, seg), (img2, _) = _inputs()[:2]
    cur, last = (jmedia.image_to_grid(i, keep_u8=True) for i in (img2, img))
    jeng.inject_flow_segments(*seg)
    jeng.composite_flow(jof.optical_flow(
        jnp.asarray(cur), jnp.asarray(last), jnp.float32(jeng.timer.time),
        offset=jnp.float32(0.05), lambda_=jnp.float32(0.001),
        speed=jnp.float32(0.08), speed_limit=jeng.params()["speedLimit"]))
    jeng.frame()
    cuda_lib.reset_counts()
    teng.inject_flow_segments(*seg)
    assert teng.sim.force is None
    teng.composite_flow(tof.optical_flow(
        torch.as_tensor(cur), torch.as_tensor(last),
        torch.tensor(teng.timer.time), offset=0.05, lambda_=0.001,
        speed=0.08, speed_limit=teng.params()["speedLimit"]))
    teng.frame()
    _compare(teng.sim, sim_arrays(jeng.sim))
    calls = cuda_lib.plain_calls
    assert calls["splat_points"] == calls["bilinear_gather"] == 1
    assert calls["gather_reconstruct"] == 1


def test_unpadded_segments_inject_the_same(start):
    """The port does not pad segments to the JAX facade's power-of-two
    bucket: zero-velocity pad segments carry zero payload weight and
    alpha, so adding them changes nothing."""
    teng = _port_engine(start)
    p0, p1, vel, width = _inputs()[-1][1]
    pad = 256 - p0.shape[0]
    padded = (np.pad(p0, ((0, pad), (0, 0))), np.pad(p1, ((0, pad), (0, 0))),
              np.pad(vel, ((0, 0), (0, pad))))
    params = teng.params()
    time = torch.tensor(teng.timer.time)
    out = [tengine._inject_flow(teng.sim.flow,
                                *(torch.as_tensor(a) for a in segs),
                                torch.tensor(width), params, time,
                                teng.config)
           for segs in ((p0, p1, vel), padded)]
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], teng.sim.flow)
