"""The port's camera and pointer inputs against the JAX package's:
`ops/optical_flow.py`, `media.py` (frame conversion and the OpticalFlow
ring), `flow_line.py`, and the payload resize of the io frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import flow_line as jflow_line, media as jmedia
from tendrils_tpu.ops import optical_flow as jof
from tendrils_tpu_torch import engine as tengine, flow_line as tflow_line
from tendrils_tpu_torch import media as tmedia
from tendrils_tpu_torch.ops import optical_flow as tof

CAM = (24, 64)
TIME = 1000.0
SPEED_LIMIT = 0.01


def _frames(seed=0, u8=True):
    """Two camera frames `[4, H, W]`: a bright bar that moved 3 px, on
    noise (the gradients are not all zero)."""
    rng = np.random.default_rng(seed)
    h, w = CAM
    imgs = []
    for shift in (0, 3):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        img[:, 20 + shift:30 + shift] = 255
        imgs.append(img)
    return [jmedia.image_to_grid(i, keep_u8=u8) for i in imgs]


def _jax_payload(cur, last, offset, speed):
    return np.asarray(jof.optical_flow(
        jnp.asarray(cur), jnp.asarray(last), jnp.float32(TIME),
        offset=jnp.float32(offset), lambda_=jnp.float32(0.001),
        speed=jnp.float32(speed), speed_limit=jnp.float32(SPEED_LIMIT)))


def _torch_payload(cur, last, offset, speed):
    return tof.optical_flow(torch.as_tensor(cur), torch.as_tensor(last),
                            torch.tensor(TIME), offset=offset,
                            lambda_=0.001, speed=speed,
                            speed_limit=torch.tensor(SPEED_LIMIT)).numpy()


def _close_payload(t, j):
    # The same f32 operations; the JAX function is jitted and XLA on the
    # CPU contracts the translate's lerps into FMAs (a last-bit change of
    # the gradients), and the unclamped t² falloff amplifies relative
    # error 3x: relative 1e-5 of each channel's largest value.
    scale = np.abs(j).reshape(4, -1).max(axis=1)[:, None, None]
    assert (scale[:, 0, 0] > 0).all()
    assert (np.abs(t - j) <= 1e-5 * scale).all()


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("offset,speed", [(0.05, 0.08), (0.2, 1.0)])
def test_optical_flow_matches_jax(u8, offset, speed):
    cur, last = _frames(u8=u8)
    assert cur.dtype == (np.uint8 if u8 else np.float32)
    _close_payload(_torch_payload(cur, last, offset, speed),
                   _jax_payload(cur, last, offset, speed))


def test_composite_flow_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.uniform(-0.01, 0.01, (4, 32, 128)).astype(np.float32)
    payload = rng.uniform(-0.01, 0.01, (4, 32, 128)).astype(np.float32)
    payload[3] = rng.uniform(0, 1, (32, 128))
    j = np.asarray(jof.composite_flow(jnp.asarray(flow),
                                      jnp.asarray(payload)))
    t = tof.composite_flow(torch.as_tensor(flow),
                           torch.as_tensor(payload)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.uint8, 4),
                                            (np.float32, 3)])
@pytest.mark.parametrize("keep_u8", [False, True])
def test_image_to_grid_matches_jax(dtype, channels, keep_u8):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (*CAM, channels)).astype(dtype)
    t = tmedia.image_to_grid(img, keep_u8=keep_u8)
    j = jmedia.image_to_grid(img, keep_u8=keep_u8)
    assert t.dtype == j.dtype and t.flags.c_contiguous
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tmedia.grid_to_image(torch.as_tensor(t)),
                                  jmedia.grid_to_image(j))


@pytest.mark.parametrize("scale_uv", [[1, -1], [-1, 1]])
def test_optical_flow_ring_matches_jax(scale_uv):
    """Three frames through both rings (set_pixels, device_buffers,
    update, step), with the scaleUV flips."""
    u = {"offset": 0.05, "speed": 0.08, "speedLimit": SPEED_LIMIT,
         "scaleUV": scale_uv}
    jring = jmedia.OpticalFlow(u)
    tring = tmedia.OpticalFlow(u, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        img = rng.integers(0, 60, (*CAM, 3)).astype(np.uint8)
        img[:, 8 * i:8 * i + 10] = 255
        jring.set_pixels(img)
        tring.set_pixels(img)
        for a, b in zip(tring.device_buffers(), jring.device_buffers()):
            assert a.dtype == torch.uint8 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        t = tring.update(TIME).numpy()
        j = np.asarray(jring.update(jnp.float32(TIME)))
        if i:
            _close_payload(t, j)
        else:  # against the zero frame: the payload is 0 where the bar is
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
        jring.step()
        tring.step()
    tring.resize((8, 16))
    assert [tuple(b.shape) for b in tring.buffers] == [(4, 8, 16)] * 2


@pytest.mark.parametrize("crest_rows", [1, 5])
def test_flow_line_segments_match_jax(crest_rows):
    view_size = np.float32(128) / np.asarray([128, 32], np.float32)
    lines = []
    for mod in (jflow_line, tflow_line):
        line = mod.FlowLine({"speed": 3.0})
        for i in range(6):
            a = 0.4 * i
            line.add(100.0 + 16.0 * i, (0.5 * np.cos(a), 0.4 * np.sin(a)))
        lines.append(line.flow_segments(TIME, view_size, (32, 128),
                                        crest_rows=crest_rows))
    for a, b in zip(*lines):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert lines[1][0].shape == (5 * crest_rows, 2)
    # FlowLines: lazily created per pointer, concatenated, trimmed.
    multi = tflow_line.FlowLines()
    multi.get("a").add(0.0, (0, 0)).add(16.0, (0.1, 0.0))
    multi.get("b").add(10.0, (0, 0))
    p0, p1, vel, width = multi.segments(TIME, view_size, (32, 128))
    assert p0.shape == (5, 2) and vel.shape == (2, 5) and width >= 1
    assert multi.trim(5.0, 20.0) == 1


@pytest.mark.parametrize("src,dst", [((24, 64), (32, 128)),
                                     ((64, 256), (32, 128)),
                                     ((48, 64), (32, 128))])
def test_payload_resize_matches_jax(src, dst):
    """Up (plain bilinear), down (antialiased) and mixed, against
    `jax.image.resize(..., "bilinear")`: the same triangle filter, ~2e-7
    apart on values in [-1, 1]."""
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (4, *src)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(a), (4, *dst), "bilinear"))
    t = tengine._resize_payload(torch.as_tensor(a), dst).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_pointer_feed_trims_like_the_demo():
    """The config-4 feed's pointers keep the last 1/flowDecay ms of their
    paths, one sample a frame, as the demo app trims them
    (`tendrils_tpu/app/demo.py:633`): at the default flowDecay 12 or 13
    samples of each of 4 pointers (the sample 200 ms old sits on the
    boundary, where rounding decides), 5 crest rows a segment."""
    from tendrils_tpu_torch import feeds
    eng = tengine.Tendrils(tengine.EngineConfig(
        root_num=4, view_res=(32, 128), flow_samples=2, flow_rows=1,
        view_samples=2), device="cpu").setup()
    feed = feeds.IoFeed(eng)
    trail = 1.0 / eng.state["flowDecay"]
    assert trail == feeds.trail_ms(eng.state["flowDecay"]) == 200.0
    for i in range(3):
        feed.frame(i)
        now = eng.timer.time
        assert len(feed.lines.active) == 4
        for line in feed.lines.active.values():
            assert line.times[-1] == now
            assert now - line.times[0] <= trail < now - line.times[0] \
                + feeds.DT + 1e-6
            assert np.allclose(np.diff(line.times), feeds.DT)
    p0 = feed.lines.segments(eng.timer.time, feed.view_size, (32, 128))[0]
    lens = [len(line) for line in feed.lines.active.values()]
    assert set(lens) <= {12, 13}
    assert p0.shape == (5 * sum(n - 1 for n in lens), 2)
