"""The interactive frame with the demo's colour maps, paused, and on the
classic stream: the port's `Tendrils.step_draw_io` against the JAX
engine's (its Pallas kernels in interpret mode) from one converted state,
fed as tests/test_torch_frame_io.py feeds it (its fixture and inputs), and
the colour maps' resize against `jax.image.resize`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import media as jmedia
from tendrils_tpu_torch import engine as tengine
from tendrils_tpu_torch import media as tmedia
from tendrils_tpu_torch.ops import cuda_lib
from test_torch_frame_io import (FRAMES, OF_U, _compare, _inputs,
                                 _jax_engine, _port_engine, start)
from torch_parity import sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)
__all__ = ["start"]  # the module-scoped fixture, shared


def _colour_maps():
    """The demo's three colour maps at test size: two audio textures
    `f32[4, 1, 32]` (a spectrum replicated to RGB, alpha 1) and a camera
    grid `f32[4, 8, 8]`, with the demo's blend weights."""
    rng = np.random.default_rng(21)
    maps = []
    for shape in ((1, 32), (1, 32), (8, 8)):
        v = rng.uniform(0, 1, shape).astype(np.float32)
        rgb = ([v, v, v] if shape[0] == 1
               else list(rng.uniform(0, 1, (3, *shape)).astype(np.float32)))
        maps.append(np.stack(rgb + [np.ones(shape, np.float32)]))
    return maps, [0.1, 0.3, 0.8]


def _run_io(jeng, teng, **kw):
    """FRAMES io frames on each side (segments, camera and colour maps as
    the demo feeds them, any of them switched off by `kw`)."""
    maps, alphas = _colour_maps()
    jring = jmedia.OpticalFlow(OF_U)
    tring = tmedia.OpticalFlow(OF_U, device="cpu")
    cuda_lib.reset_counts()
    for img, seg in _inputs():
        for eng, ring in ((jeng, jring), (teng, tring)):
            ring.set_pixels(img)
            eng.timer.tick()
            args = dict(color_maps=maps, color_alphas=alphas, segments=seg,
                        of_frames=ring.device_buffers(), of_uniforms=OF_U)
            args.update(kw)
            eng.step_draw_io(**args)
            ring.step()
    assert teng.timer.time == jeng.timer.time
    return cuda_lib.plain_calls


@pytest.mark.parametrize("paused", [False, True], ids=["running", "paused"])
def test_io_frames_with_colour_maps_match_jax(start, paused):
    """The demo's io frame with its three colour maps, blended and resized
    to the camera grid's shape: running, the resident draw packs rgba8
    colours from the textured map (K1/K2 with key_recon) and gathers the
    force with K8 after the edits; paused, a plain draw (no row ids, the
    exact p0 stream, the XLA tail), the edits, and no force."""
    jeng, teng = _jax_engine(start), _port_engine(start)
    for eng in (jeng, teng):
        eng.timer.paused = paused
    calls = _run_io(jeng, teng)
    assert teng.config.color_map_res == jeng.config.color_map_res == (8, 8)
    np.testing.assert_allclose(teng.sim.color_map.numpy(),
                               np.asarray(jeng.sim.color_map), atol=1e-6)
    _compare(teng.sim, sim_arrays(jeng.sim))
    if paused:
        assert calls["pack_p0_rgba"] == calls["splat_p0_rgba"] == FRAMES
        assert calls["resolve"] == calls["gather_keyed_q15"] == 0
        assert teng.sim.force is None
    else:
        assert calls["pack_rgba"] == calls["splat_rgba"] == FRAMES
        assert calls["reconstruct_resident"] == FRAMES
        assert calls["gather_keyed_p1"] == FRAMES
    assert calls["splat_points"] == FRAMES
    assert calls["pack"] == calls["gather_reconstruct"] == 0


@pytest.mark.parametrize("edits", [True, False],
                         ids=["segments+optical-flow", "neither"])
def test_classic_io_frames_match_jax(start, edits):
    """The classic io frame (`resident_stream=False`): the draw keeps the
    row order and sends the exact p0 and rgba8 streams; the force is
    gathered with K7 and un-sorted, from the final flow after the edits,
    or from K3's decayed flow without them."""
    jeng = _jax_engine(start, resident_stream=False)
    teng = _port_engine(start, resident_stream=False)
    kw = {} if edits else dict(segments=None, of_frames=None)
    calls = _run_io(jeng, teng, **kw)
    _compare(teng.sim, sim_arrays(jeng.sim))
    assert calls["pack_p0_rgba"] == calls["resolve"] == FRAMES
    assert calls["gather_keyed_q15"] == FRAMES
    assert calls["splat_points"] == (FRAMES if edits else 0)
    assert calls["gather_keyed_p1"] == calls["reconstruct_resident"] == 0


@pytest.mark.parametrize("src,dst", [((1, 32), (24, 40)), ((8, 8), (4, 40)),
                                     ((1, 512), (48, 64))],
                         ids=["upsample", "shrink-one-axis", "audio-map"])
def test_resize_colour_map_matches_jax(src, dst):
    """`_resize_payload` on any `f32[C, h, w]` against `jax.image.resize(...,
    "bilinear")`: an upsample, a map that shrinks along one axis
    (antialiased there) and an audio map to a camera-shaped grid."""
    import jax.image
    g = np.random.default_rng(22).uniform(0, 1, (4, *src)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(g), (4, *dst), "bilinear")
    got = tengine._resize_payload(torch.as_tensor(g), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
