"""The port's demo application (`tendrils_tpu_torch/app/`) against the JAX
package's: the preset library, the host state every preset leaves, the
keyboard map and the scroll sequencer on scripted input, the quality
tiers, the demo's feeds and spawns, and replay across two instances.

Both demos run on the CPU at a test size; the JAX demo on its default
(xla) backend, since these tests compare host state only. The frames
themselves are compared in tests/test_torch_app_frames.py and the
preset corridors in tests/test_torch_app_corridors.py.

Tolerance: none for host state. The demo's host side is the same Python
on the same values in both packages, so every dict, list and number must
be equal (`==`). The port's own runs are held by identity of digests
(replay) or by finiteness and signs of life.
"""

import math
import wave

import numpy as np
import pytest
import torch

from tendrils_tpu.app import PRESETS as JPRESETS, demo as jdemo
from tendrils_tpu.app.keys import KeyMash as JKeyMash
from tendrils_tpu.app.sub import SubSequencer as JSubSequencer
from tendrils_tpu_torch.app import PRESETS as TPRESETS, demo as tdemo
from tendrils_tpu_torch.app.keys import KeyMash as TKeyMash
from tendrils_tpu_torch.app.sub import SubSequencer as TSubSequencer
from test_golden import _traj_digest

CFG = dict(view_res=(36, 64), root_num=16, flow_samples=2, flow_rows=1,
           view_samples=2)
# The host-side objects a preset sets (`demo.py`'s apply_preset).
HOST = ("state", "color_proxy", "blend_proxy", "audio_state", "blur_state",
        "bokeh_state", "optical_flow_state", "flow_pixel_state",
        "spawn_targets", "base")


def _jax_demo(settings=None):
    return jdemo.TendrilsDemo(dict(settings or {}), **CFG)


def _port_demo(settings=None):
    return tdemo.TendrilsDemo(dict(settings or {}), device="cpu", **CFG)


def _image(seed=0, shape=(24, 32)):
    return np.random.default_rng(seed).uniform(0, 255, (*shape, 3)).astype(
        np.uint8)


def host_state(demo):
    """What the demo's host side holds: its preset-set dicts, the spawner
    uniforms, the engine's config and flags, the timers."""
    out = {k: getattr(demo, k) for k in HOST}
    out.update(
        spawn=dict(demo.reset_spawner.uniforms),
        preset=demo.preset_auto["current"],
        quality=demo.quality,
        root=demo.tendrils.config.root_num,
        color_map_res=tuple(demo.tendrils.config.color_map_res),
        targets_live=demo.tendrils._targets_live,
        times=(demo.timer["app"].time, demo.timer["track"].time),
        frame_count=demo.frame_count)
    return out


def keyframes(demo):
    """The keyframes of the demo's "tendrils" track, without their calls
    (closures of each package)."""
    return [(f.get("to"), f["time"], f.get("ease"))
            for f in demo.player["track"].tracks["tendrils"].frames]


def test_presets_equal_jax():
    """All 41 presets (the reference registers 41, two of them aliases),
    in the same order, deep-equal."""
    assert len(TPRESETS) == 41
    assert list(TPRESETS) == list(JPRESETS)
    assert TPRESETS == JPRESETS


@pytest.fixture(scope="module")
def preset_demos():
    """One demo on each side, a static image set (so that the image
    spawns of `spawnSamples` and `spawnImageTargets` run), presets applied
    in turn by the tests below."""
    demos = _jax_demo(), _port_demo()
    for d in demos:
        d.set_image(_image())
    return demos


@pytest.mark.parametrize("name", list(JPRESETS))
def test_apply_preset_host_state_matches_jax(preset_demos, name):
    """After `apply_preset(name)` (after the presets before it), the same
    host state on both sides: `state`, `color_proxy`, `blend_proxy`,
    `audio_state`, `blur_state`, `bokeh_state`, `optical_flow_state`,
    `flow_pixel_state`, the spawn targets, the background, the spawner's
    uniforms, the config and the timers."""
    jd, td = preset_demos
    jd.apply_preset(name)
    td.apply_preset(name)
    assert host_state(td) == host_state(jd)
    sim = td.tendrils.sim
    assert torch.isfinite(sim.particles).all()
    assert (sim.particles[0] > -9e5).any()


def test_keymash_matches_jax():
    """A scripted sequence through both layouts: the performance map's
    preset, spawn and toggle keys, then the editor map's field selection,
    arrow and +/- adjustments and the keyframe recorded on release. The
    same return values, the same state and the same recorded keyframes
    after every event."""
    for settings, script in (
            ({}, [("down", "6"), ("down", "`"), ("down", "P"),
                  ("down", "\\"), ("down", "<space>"), ("down", "J"),
                  ("up", "J"), ("down", "not-a-key")]),
            ({"editor_keys": "true"},
             [("down", "Q"), ("down", "<up>"), ("down", "<left>"),
              ("down", "="), ("up", "Q"), ("down", "A"), ("down", "-"),
              ("down", "S"), ("down", "<down>"), ("up", "A"), ("up", "S"),
              ("down", "P"), ("up", "P"), ("down", "1"), ("down", "O"),
              ("down", "<enter>"), ("down", "<space>"), ("down", "<space>"),
              ("up", "Z")])):
        demos = _jax_demo(settings), _port_demo(settings)
        maps = JKeyMash(demos[0]), TKeyMash(demos[1])
        assert sorted(maps[0].call_map) == sorted(maps[1].call_map)
        assert sorted(maps[0].edit_map) == sorted(maps[1].edit_map)
        for kind, key in script:
            got = [getattr(m, f"key_{kind}")(key) for m in maps]
            assert got[0] == got[1], (kind, key)
            assert host_state(demos[1]) == host_state(demos[0]), (kind, key)
            assert sorted(maps[0].editing) == sorted(maps[1].editing)
            assert demos[0].track_playing == demos[1].track_playing
            assert keyframes(demos[0]) == keyframes(demos[1])


def test_sub_sequencer_matches_jax():
    """Sections by visibility: the most visible preset wins, triggers
    queue on their schedules as they come into view and fire when due;
    the same preset, queue and demo state at every step."""
    demos = _jax_demo(), _port_demo()
    seqs = [S(d, trigger_times={"restart": [0.0, 50.0]})
            for S, d in zip((JSubSequencer, TSubSequencer), demos)]
    for seq in seqs:
        seq.add_section(preset="Flow")
        seq.add_section(preset="Rave", trigger="clearView")
        seq.add_section(trigger="restart")
    for d in demos:
        d.render()
    for ratios, now in (([0.8, 0.1, 0.0], 0.0), ([0.2, 0.9, 0.0], 10.0),
                        ([0.0, 0.4, 1.0], 100.0), ([0.0, 0.0, 0.5], 120.0),
                        ([0.6, 0.0, 0.0], 200.0), ([0.6, 0.0, 0.0], 260.0)):
        for seq in seqs:
            seq.observe(ratios, now=now)
            seq.tick(now)
        assert seqs[0].preset == seqs[1].preset
        assert seqs[0].pending == seqs[1].pending
        assert [s.ratio for s in seqs[0].sections] == \
            [s.ratio for s in seqs[1].sections]
        assert host_state(demos[1]) == host_state(demos[0])


def test_quality_tiers_match_jax():
    """`quality_change` through the tiers x1, x2, x4 and back (the
    constructed root times 1, 2, 4; each a re-setup), a frame after each:
    the same root, damping and host state, and a live, finite state."""
    demos = _jax_demo(), _port_demo()
    for level in (1, 2, 0, 2, None):
        for d in demos:
            d.quality_change(level)
            d.render()
        assert host_state(demos[1]) == host_state(demos[0])
        n = demos[1].tendrils.config.n
        assert demos[1].tendrils.sim.particles.shape == (4, n)
        assert torch.isfinite(demos[1].screen).all()
    assert [o["rootNum"] for o in demos[1].quality["options"]] == \
        [16, 32, 64]


def test_demo_api_matches_jax():
    """The settings the constructor parses, the exported controls and
    preset callables, `show_link` and `keyframe`."""
    settings = {"preset": "Rave", "animate": "true", "mic_track": "true",
                "loop_presets": "500", "frame_step": "2", "quality": "1",
                "flip_video_x": "true", "mute": "true", "track_in": "0.5"}
    demos = _jax_demo(settings), _port_demo(settings)
    assert demos[0].app_settings == demos[1].app_settings
    assert demos[0].audio_defaults == demos[1].audio_defaults
    assert host_state(demos[1]) == host_state(demos[0])
    assert sorted(demos[0].controls) == sorted(demos[1].controls)
    assert sorted(demos[0].presets) == sorted(demos[1].presets)
    assert demos[0].show_link() == demos[1].show_link()
    for d in demos:
        d.keyframe()
    assert keyframes(demos[0]) == keyframes(demos[1])


def test_preset_autoloop_matches_jax():
    """With `loop_presets`, the demo moves to the next preset every
    `loop` ms of app time: the same sequence of presets and host state
    over 12 frames."""
    demos = _jax_demo({"loop_presets": "40"}), _port_demo(
        {"loop_presets": "40"})
    for _ in range(12):
        for d in demos:
            d.render()
        assert host_state(demos[1]) == host_state(demos[0])
    assert demos[1].preset_auto["current"] > 0


def test_audio_response_matches_jax(tmp_path):
    """The trigger tables on both sides: a hair-trigger mic threshold
    with a jumping spectrum, and a playing WAV track with the timeline
    animating (`animate=true`): the same reactions (by the host state
    they leave) and the same textures, frame by frame."""
    sr = 8000
    t = np.arange(sr) / sr
    pcm = (np.sin(2 * math.pi * 440 * t * (1 + 2 * t)) * 20000).astype(
        np.int16)
    path = str(tmp_path / "t.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    settings = {"track": path, "animate": "true"}
    demos = _jax_demo(settings), _port_demo(settings)
    rng = np.random.default_rng(4)
    for d in demos:
        d.set_image(_image(1))
        d.audio_state.update(micFlowAt=1e-6, micFastAt=0, micFormAt=0,
                             micSampleAt=0, micCamAt=0, micSpawnAt=0)
        d.play_track()
    for i in range(8):
        spec = rng.uniform(0, 255, 512) * (i % 2)
        for d in demos:
            d.feed_mic_spectrum(spec)
            d.render()
        assert host_state(demos[1]) == host_state(demos[0])
        np.testing.assert_array_equal(demos[0].track_texture.array,
                                      demos[1].track_texture.array)
        np.testing.assert_array_equal(demos[0].mic_texture.array,
                                      demos[1].mic_texture.array)
    assert demos[1].track_texture.array.max() > 0
    assert torch.isfinite(demos[1].tendrils.sim.particles).all()


def test_feeds_and_spawns_run_on_the_port():
    """The port's demo on the CPU with every feed and spawn: a camera
    frame (flipped), pointers, a static image, each control; the flow
    gains pointer weight, the screen is finite and of the view's shape,
    and `screen_image` is the screen as `[H, W, 4]`, row 0 at the top."""
    d = _port_demo({"flip_video_y": "true"})
    d.set_image(_image(2))
    for i in range(4):
        d.feed_video_frame(_image(3 + i, (24, 40)))
        d.pointer_move(1, 10.0 + i * 6, 18.0)
        d.render()
    assert float(d.tendrils.sim.flow[3].max()) > 0
    h, w = CFG["view_res"]
    img = d.screen_image
    assert tuple(img.shape) == (h, w, 4) and torch.isfinite(img).all()
    assert torch.equal(img, d.screen.permute(1, 2, 0).flip(0))
    for name, fn in d.controls.items():
        fn() if name != "toggleBase" else fn("light")
        d.render()
        assert torch.isfinite(d.tendrils.sim.particles).all(), name
    for scale in ("normal", "mirror x", "mirror y", "mirror xy"):
        d.flow_pixel_state["scale"] = scale
        d.spawn_flow()
    assert d.tendrils.sim.color_map.shape[1:] == (24, 40)
    assert d.base == "light"


def test_replay_deterministic_across_instances():
    """Two port demos replay `Starlings` (with its image spawn, a camera
    frame and a pointer a frame) to the same digest of the particles and
    the view, as tests/test_golden.py requires of the JAX demo."""
    def run():
        d = _port_demo()
        d.set_image(_image(5))
        d.apply_preset("Starlings")
        for i in range(6):
            d.feed_video_frame(_image(6 + i))
            d.pointer_move(0, 5.0 + 4 * i, 20.0)
            d.render()
        return (_traj_digest(d.tendrils.sim.particles.numpy()),
                _traj_digest(d.tendrils.sim.view.numpy()))

    assert run() == run()
