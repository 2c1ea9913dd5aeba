"""The demo application — headless port of `src/demo.main.js` (3,625 LoC).

Everything the reference demo wires up, minus the browser chrome: settings
parsing, engine + spawner wiring, pointer flow-lines, optical-flow-from-video
pipeline, audio track/mic analysers with the full trigger tables, colour-map
blending, blur post, quality tiers, the animation player with the track-start
timeline, the 41-preset library, the keyboard performance map, and the
exported API object. Interactive clients (GUI, pointer, camera, audio device)
drive it through the feed methods (`pointer_move`, `feed_video_frame`,
`feed_mic_spectrum`) — interactivity is a client concern (SURVEY §7).

The port of `tendrils_tpu/app/demo.py`. The same wiring drives the port's
`Tendrils` and `OpticalFlow` on `device` ("cuda" by default; the tests pass
"cpu"); each frame is `Tendrils.step_draw_io` on the hand-written kernels.
The host keeps its own copy of the view's aspect (`_host_view_size`), so no
frame reads a device tensor back for the pointer lines or the flow spawn.
"""

from __future__ import annotations

import urllib.parse

import numpy as np

from .. import EngineConfig, Tendrils, Timer, default_state
from ..animate import Player
from ..audio import (Analyser, AudioTexture, AudioTrigger, WavAnalyser,
                     mean_weight, peak)
from ..flow_line import FlowLines
from ..media import OpticalFlow, image_to_grid
from ..ops import coords
from ..spawners import GeometrySpawner, PixelSpawner, spawn_ball
from .presets import PRESETS

# Flow-lookup mirror modes — ref `demo.main.js:408-414`.
FLOW_PIXEL_SCALES = {
    "normal": [1, -1],
    "mirror x": [-1, -1],
    "mirror y": [1, 1],
    "mirror xy": [-1, 1],
}


def audio_defaults(settings):
    """Ref `demo.main.js:170-202`."""
    mic_track = str(settings.get("mic_track", "")) == "true"
    out = {
        "audible": str(settings.get("mute", "")) != "true",
        "track": float(settings.get("track_in", 1)),
        "trackFlowAt": 0.2,
        "trackFastAt": 0.03,
        "trackFormAt": 0.015,
        "trackSampleAt": 0.035,
        "trackCamAt": 0.002,
        "trackSpawnAt": 0.045,
        "mic": float(settings.get("mic_in", 1)),
    }
    if mic_track:
        out.update(micFlowAt=0.2, micFastAt=0.03, micFormAt=0.015,
                   micSampleAt=0.035, micCamAt=0.002, micSpawnAt=0.045)
    else:
        out.update(micFlowAt=0.5, micFastAt=0.8, micFormAt=0.5,
                   micSampleAt=0.74, micCamAt=0.06, micSpawnAt=0.09)
    return out


class TendrilsDemo:
    """`tendrilsDemo(canvas, options)` equivalent — ref `demo.main.js:70`."""

    def __init__(self, settings=None, view_res=(720, 1280), device="cuda",
                 **engine_kw):
        self.settings = dict(settings or {})
        s = self.settings

        # App settings — ref `demo.main.js:125-160`.
        self.app_settings = {
            "trackURL": s.get("track", ""),
            "animate": str(s.get("animate", "")) == "true",
            "editorKeys": str(s.get("editor_keys", "")) == "true",
            "useMedia": str(s.get("use_media", "")) != "false",
            "useCamera": str(s.get("use_camera", "")) != "false",
            "useMic": str(s.get("use_mic", "")) != "false",
            "flipVideoX": str(s.get("flip_video_x", "")) == "true",
            "flipVideoY": str(s.get("flip_video_y", "")) == "true",
            "loopTime": max(0, int(s.get("loop_time", 10 * 60 * 10e2))),
            "loopPresets": max(0, int(s.get("loop_presets", 0))),
            "pointerFlow": str(s.get("pointer_flow", "")) != "false",
            "staticImage": s.get("static_image", ""),
            "frameStep": max(0.0, float(s.get("frame_step", 0))),
        }

        # Timers — app timer fixed-step by default for determinism.
        self.timer = {"app": Timer(), "track": Timer(0)}
        self.timer["app"].step = 1000.0 / 60.0
        self.timer["app"].end = self.app_settings["loopTime"]
        self.timer["app"].loop = bool(self.app_settings["loopTime"])

        eng_cfg = dict(view_res=view_res)
        eng_cfg.update(engine_kw)
        seed = eng_cfg.pop("seed", 0)
        self.tendrils = Tendrils(EngineConfig(**eng_cfg),
                                 timer=self.timer["app"], seed=seed,
                                 device=device)
        self.state = self.tendrils.state
        self.default_state = default_state()

        # Spawners — ref `demo.main.js:100-130, 403-521`.
        self.spawn_targets = {}
        self.reset_spawner = spawn_ball(radius=0.3, speed=0.005)
        self.reset_spawner_defaults = {"radius": 0.3, "speed": 0.005}

        self.flow_pixel_spawner = PixelSpawner(shader="flow-sample")
        self.flow_pixel_defaults = {"scale": "normal"}
        self.flow_pixel_state = dict(self.flow_pixel_defaults)

        self.simple_pixel_spawner = PixelSpawner(shader="data-sample")
        self.geometry_spawner = GeometrySpawner(speed=0.005, bias=1e2 / 5e-3)
        self.image_spawners = {
            "direct": PixelSpawner(shader="direct"),
            "sample": PixelSpawner(shader="best-sample"),
        }
        self.image_spawners["direct"].spawn_matrix[0, 0] = -1  # flip X
        self.image_spawners["sample"].spawn_matrix[0, 0] = -1
        self.image = None  # static image grid, set via set_image

        # Pointer flow lines — ref `demo.main.js:377-394`.
        self.flow_inputs = FlowLines()

        # Optical flow — ref `demo.main.js:525-536`.
        self.optical_flow = OpticalFlow({
            "speed": float(s.get("optical_speed", 0.08)),
            "offset": 0.1,
            "scaleUV": [-1, -1],  # mirrored camera — ref demo.main.js:529
        }, device=device)
        self.optical_flow_state = {
            "speed": self.optical_flow.uniforms["speed"],
            "lambda": self.optical_flow.uniforms["lambda"],
            "offset": self.optical_flow.uniforms["offset"],
        }
        self.optical_flow_defaults = dict(self.optical_flow_state)
        self._video_frame = None

        # Audio — ref `demo.main.js:162-202, 652-767`.
        self.audio_defaults = audio_defaults(s)
        self.audio_state = dict(self.audio_defaults)
        self.track_analyser = (WavAnalyser(self.app_settings["trackURL"])
                               if str(self.app_settings["trackURL"])
                               .endswith(".wav") else Analyser())
        self.mic_analyser = Analyser()
        self.track_trigger = AudioTrigger(self.track_analyser, 4)
        self.mic_trigger = AudioTrigger(self.mic_analyser, 4)
        self.track_texture = AudioTexture(
            self.track_analyser.frequency_bin_count)
        self.mic_texture = AudioTexture(
            self.mic_analyser.frequency_bin_count)
        self.track_playing = False
        self._audio_cache = {}

        # Colour-map blend — ref `demo.main.js:548-560, 1070-1079`.
        self.blend_keys = ["mic", "track", "video"]
        self.blend_defaults = {"mic": 0.1, "track": 0.3, "video": 0.8}
        self.blend_proxy = dict(self.blend_defaults)

        # Blur — ref `demo.main.js:790-806`.
        self.blur_defaults = {"radius": 3, "limit": 0.5}
        self.blur_state = {"radius": 5, "limit": 0.4}

        # Bokeh — the reference ships the shader (`src/screen/bokeh.frag`)
        # but its demo never wires it; we expose it as an optional screen
        # pass after blur (off by default, settable via `bokeh_radius` /
        # `bokeh_amount` settings or a preset's "bokeh" section).
        self.bokeh_state = {
            "radius": float(s.get("bokeh_radius", 0)),
            "amount": float(s.get("bokeh_amount", 0)),
        }
        # Settings-derived values are the reset baseline (same pattern as
        # `optical_flow_defaults`): presets without a "bokeh" section keep
        # the caller's setting.
        self.bokeh_defaults = dict(self.bokeh_state)

        # Colour proxy — ref `demo.main.js:1326-1338`.
        st = self.state
        self.color_defaults = {
            "baseColor": [c * 255 for c in st["baseColor"][:3]],
            "baseAlpha": st["baseColor"][3],
            "flowColor": [c * 255 for c in st["flowColor"][:3]],
            "flowAlpha": st["flowColor"][3],
            "fadeColor": [c * 255 for c in st["fadeColor"][:3]],
            "fadeAlpha": st["fadeColor"][3],
        }
        self.color_proxy = {k: (list(v) if isinstance(v, list) else v)
                            for k, v in self.color_defaults.items()}

        self.base = "dark"

        # Quality tiers — ref `demo.main.js:978-1009`. Tiers are ×1/×2/×4
        # of the CONSTRUCTED engine's root (== the reference's default-state
        # rootNum unless the caller overrode `root_num`; honoring the
        # override keeps small test/embedding instances small through
        # `quality_change`'s re-setup).
        d = self.default_state
        base_root = self.tendrils.config.root_num
        self.quality = {
            "options": [
                {"rootNum": base_root, "damping": d["damping"]},
                {"rootNum": base_root * 2, "damping": d["damping"] - 1e-3},
                {"rootNum": base_root * 4, "damping": d["damping"] - 2e-3},
            ],
            "level": int(s.get("quality", 0)),
        }

        # Animation player — ref `demo.main.js:816-851`.
        self.tracks = {
            "tendrils": self.state,
            "tendrils2": self.state,
            "tendrils3": self.state,
            "baseColor": self.state["baseColor"],
            "flowColor": self.state["flowColor"],
            "fadeColor": self.state["fadeColor"],
            "spawn": self.reset_spawner.uniforms,
            "opticalFlow": self.optical_flow_state,
            "audio": self.audio_state,
            "blend": self.blend_proxy,
            "blur": self.blur_state,
            "bokeh": self.bokeh_state,
            "calls": {},
        }
        self.player = {
            "track": Player({k: [] for k in self.tracks}, self.tracks),
            "app": Player({"main": []}, {"main": self.state}),
        }
        self._setup_track_start()

        self.preset_auto = {"current": 0,
                            "loop": self.app_settings["loopPresets"],
                            "elapsed": 0.0}

        self._fires = self._make_fires()
        self.frame_count = 0
        self.screen = None  # last composited output (set per frame)

        # Go — ref `demo.main.js:1193-1196`.
        self.quality_change(self.quality["level"])
        self.respawn()

        if s.get("preset") in PRESETS:
            self.apply_preset(s["preset"])

    # -- convenience controls (ref demo.main.js:105-123)

    def respawn(self, target=None):
        self.reset_spawner.spawn(
            self.tendrils, target or self.spawn_targets.get("respawn"))

    def reset(self):
        self.tendrils.reset()

    def restart(self):
        self.tendrils.clear()
        self.respawn()
        self.respawn("targets")
        self.timer["app"].time = 0

    def clear(self):
        self.tendrils.clear()

    def clear_view(self):
        self.tendrils.clear_view()

    def clear_flow(self):
        self.tendrils.clear_flow()

    def toggle_base(self, background=None):
        self.base = background or ("light" if self.base == "dark" else
                                   "dark")

    # -- spawn wiring (ref demo.main.js:398-521)

    def _host_view_size(self):
        """The engine's `_view_size` (`cover_aspect` of the view), as the
        host numpy array it is made from."""
        h, w = self.tendrils.config.view_res
        return coords.cover_aspect((w, h))

    def spawn_flow(self, target=None):
        """Feedback respawn from the flow field — ref `demo.main.js:421-427`."""
        scale = FLOW_PIXEL_SCALES[self.flow_pixel_state["scale"]]
        vs = self._host_view_size()
        self.flow_pixel_spawner.spawn_size = [scale[0] / vs[0],
                                              scale[1] / vs[1]]
        self.flow_pixel_spawner.set_pixels(self.tendrils.sim.flow)
        self.flow_pixel_spawner.spawn(
            self.tendrils, target=target or self.spawn_targets.get(
                "spawnFlow"))

    def spawn_fastest(self, target=None):
        """Respawn on fastest particles — ref `demo.main.js:432-441`."""
        self.simple_pixel_spawner.set_pixels(
            self.tendrils.sim.particles.reshape(
                4, self.tendrils.config.root_num,
                self.tendrils.config.root_num))
        self.simple_pixel_spawner.spawn_size = [1.0, 1.0]
        self.simple_pixel_spawner.spawn(
            self.tendrils,
            target=target or self.spawn_targets.get("spawnFastest"))

    def spawn_form(self, target=None):
        """Platonic-form respawn — ref `demo.main.js:446-450`."""
        self.geometry_spawner.shuffle().spawn(
            self.tendrils,
            target=target or self.spawn_targets.get("spawnForm"))

    def set_image(self, image):
        """Set the static spawn image (`[H, W, C]` array)."""
        self.image = image_to_grid(image)

    def _spawn_raster(self, which, speed, target):
        """Ref `demo.main.js:492-510`."""
        source = None
        if (self.app_settings["useMedia"] and self.app_settings["useCamera"]
                and self._video_frame is not None):
            source = self._video_frame
        elif self.image is not None:
            source = self.image
        if source is None:
            return  # image not ready — ref warning demo.main.js:508
        sp = self.image_spawners[which]
        sp.speed = speed
        sp.set_pixels(source)
        self.tendrils.set_color_map(source)
        sp.spawn(self.tendrils, target=target)

    def spawn_image(self, target="unset"):
        if target == "unset":
            target = self.spawn_targets.get("spawnImage")
        self._spawn_raster("direct", 0.3, target)

    def spawn_samples(self, target=None):
        self._spawn_raster(
            "sample", 1, target or self.spawn_targets.get("spawnSamples"))

    def spawn_image_targets(self):
        """Ref `demo.main.js:517-521`."""
        self.spawn_targets["spawnImage"] = "targets"
        self.spawn_image("targets")
        self.spawn_image(None)

    # -- inputs

    def pointer_move(self, pointer_id, x, y):
        """Client pixel coords -> NDC path point — ref `demo.main.js:380-394`."""
        if not self.app_settings["pointerFlow"]:
            return
        h, w = self.tendrils.config.view_res
        p = (x / w * 2 - 1, -(y / h * 2 - 1))
        self.flow_inputs.get(pointer_id).add(self.timer["app"].time, p)

    def feed_video_frame(self, frame):
        """Push a camera/video frame (`[H, W, C]`, row 0 top)."""
        frame = np.asarray(frame)
        if self.app_settings["flipVideoX"]:
            frame = frame[:, ::-1]
        if self.app_settings["flipVideoY"]:
            frame = frame[::-1]
        self._video_frame = image_to_grid(frame)

    def feed_mic_spectrum(self, frequencies):
        self.mic_analyser.push(frequencies=frequencies)

    def play_track(self):
        self.track_playing = True

    def pause_track(self):
        self.track_playing = False

    # -- audio triggers (ref demo.main.js:652-792)

    def _firer(self, threshold_key, test):
        """Threshold-gated, per-frame-cached test — ref `audioFirer`,
        `demo.main.js:633-650`."""

        def fire(trigger):
            t = self.audio_state[threshold_key]
            if not t:
                return False
            key = threshold_key
            if key not in self._audio_cache:
                self._audio_cache[key] = test(trigger, t)
            return self._audio_cache[key]

        return fire

    def _make_fires(self):
        mw = mean_weight

        def table(prefix, mic_track):
            # Track table and mic_track=true mic table share shapes —
            # ref demo.main.js:652-767.
            if prefix == "track" or mic_track:
                return [
                    (self.spawn_flow, f"{prefix}FlowAt",
                     lambda tr, t: mw(tr.data_order(1), 0.25) > t),
                    (self.spawn_fastest, f"{prefix}FastAt",
                     lambda tr, t: mw(tr.data_order(2), 0.8) > t),
                    (self.spawn_form, f"{prefix}FormAt",
                     lambda tr, t: abs(peak(tr.data_order(3))) > t),
                    (self.spawn_samples, f"{prefix}SampleAt",
                     lambda tr, t: mw(tr.data_order(2), 0.25) > t),
                    (self.spawn_image_targets, f"{prefix}CamAt",
                     lambda tr, t: mw(tr.data_order(3), 0.5) > t),
                    (self.restart, f"{prefix}SpawnAt",
                     lambda tr, t: mw(tr.data_order(2), 0.25) > t),
                ]
            return [
                (self.spawn_flow, "micFlowAt",
                 lambda tr, t: mw(tr.data_order(1), 0.3) > t),
                (self.spawn_fastest, "micFastAt",
                 lambda tr, t: mw(tr.data_order(1), 0.7) > t),
                (self.spawn_form, "micFormAt",
                 lambda tr, t: abs(peak(tr.data_order(2))) > t),
                (self.spawn_samples, "micSampleAt",
                 lambda tr, t: mw(tr.data_order(1), 0.4) > t),
                (self.spawn_image_targets, "micCamAt",
                 lambda tr, t: mw(tr.data_order(2), 0.6) > t),
                (self.restart, "micSpawnAt",
                 lambda tr, t: mw(tr.data_order(2), 0.3) > t),
            ]

        mic_track = str(self.settings.get("mic_track", "")) == "true"
        return {
            "track": [(react, self._firer(key, test))
                      for react, key, test in table("track", True)],
            "mic": [(react, self._firer(key, test))
                    for react, key, test in table("mic", mic_track)],
        }

    def audio_response(self):
        """Sequential, one reaction per frame — ref `demo.main.js:775-792`."""
        sound = False
        if self.audio_state["track"] > 0 and self.track_playing:
            for react, test in self._fires["track"]:
                if self.track_trigger.fire(lambda tr: react(), test):
                    sound = True
                    break
        if not sound and self.audio_state["mic"] > 0:
            for react, test in self._fires["mic"]:
                if self.mic_trigger.fire(lambda tr: react(), test):
                    sound = True
                    break
        self._audio_cache.clear()
        return sound

    # -- quality (ref demo.main.js:978-1009)

    def quality_change(self, level=None):
        q = self.quality
        if level is None:
            level = (q["level"] + 1) % len(q["options"])
        opts = q["options"][level]
        self.tendrils.setup(opts["rootNum"])
        self.state.update(opts)
        self.restart()
        q["level"] = level

    # -- timeline (ref demo.main.js:853-976)

    def _setup_track_start(self):
        """The reset-to-start track sequence — ref `demo.main.js:862-949`."""
        tracks_start = {
            "tendrils": {
                "autoClearView": False, "autoFade": True,
                "forceWeight": 0.017, "varyForce": -0.25, "flowWeight": 1,
                "varyFlow": 0.3, "flowDecay": 0.003, "flowWidth": 5,
                "speedAlpha": 0.0005, "colorMapAlpha": 0.5,
            },
            "tendrils2": {
                "noiseWeight": 0.0003, "varyNoise": 0.3, "noiseScale": 1.5,
                "varyNoiseScale": 1, "noiseSpeed": 0.0006,
                "varyNoiseSpeed": 0.05,
            },
            "tendrils3": {"target": 0.000005, "varyTarget": 1,
                          "lineWidth": 1},
            "baseColor": [0, 0, 0, 0.9],
            "flowColor": [1, 1, 1, 0.1],
            "fadeColor": [1, 1, 1, 0.05],
            "spawn": {"radius": 0.6, "speed": 0.1},
            "opticalFlow": dict(self.optical_flow_defaults),
            "audio": dict(self.audio_defaults),
            "blend": {"mic": 0, "track": 0, "video": 1},
            "blur": dict(self.blur_state),
            "calls": None,
        }
        start_time = 60
        calls_track = self.player["track"].tracks["calls"]
        calls_track.to({"call": [lambda *a: self.reset()],
                        "time": start_time})
        calls_track.to({"call": [lambda *a: (self.restart(),
                                             self.toggle_base("dark"))],
                        "time": 200})
        for key, track in self.player["track"].tracks.items():
            apply = tracks_start.get(key)
            if apply is not None and key != "calls":
                track.to({"to": apply, "time": start_time})

    def keyframe(self, to=None, call=None):
        """Capture live state into the timeline — ref `demo.main.js:1267-1274`."""
        self.player["track"].tracks["tendrils"].smooth_to({
            "to": dict(self.state) if to is None else to,
            "call": call,
            "time": self.timer["track"].time,
            "ease": [0, 0.95, 1]})

    def show_link(self):
        """Shareable settings export — ref `demo.main.js:1281-1293`."""
        qs = dict(self.settings)
        qs.update(track=self.app_settings["trackURL"],
                  mute=not self.audio_state["audible"],
                  track_in=self.audio_state["track"],
                  mic_in=self.audio_state["mic"],
                  use_media=self.app_settings["useMedia"],
                  use_camera=self.app_settings["useCamera"],
                  use_mic=self.app_settings["useMic"],
                  animate=self.app_settings["animate"])
        return "?" + urllib.parse.urlencode(
            {k: str(v) for k, v in qs.items()})

    # -- colours

    def _convert_colors(self):
        """colorProxy -> engine colour state — ref `demo.main.js:1340-1353`."""
        cp = self.color_proxy
        self.state["baseColor"] = [c / 255 for c in cp["baseColor"]] + [
            cp["baseAlpha"]]
        self.state["flowColor"] = [c / 255 for c in cp["flowColor"]] + [
            cp["flowAlpha"]]
        self.state["fadeColor"] = [c / 255 for c in cp["fadeColor"]] + [
            cp["fadeAlpha"]]

    # -- presets (ref demo.main.js:3244-3289)

    def apply_preset(self, name):
        """Reset-then-apply — ref `wrapPresetter`, `demo.main.js:3244-3264`."""
        preset = PRESETS[name]

        # Reset all live state to defaults.
        self.state.update({k: v for k, v in self.default_state.items()
                           if k != "rootNum"})
        self.reset_spawner.uniforms.update(self.reset_spawner_defaults)
        self.flow_pixel_state.update(self.flow_pixel_defaults)
        self.optical_flow_state.update(self.optical_flow_defaults)
        self.color_proxy.update(
            {k: (list(v) if isinstance(v, list) else v)
             for k, v in self.color_defaults.items()})
        self.blend_proxy.update(self.blend_defaults)
        self.blur_state.update(self.blur_defaults)
        self.bokeh_state.update(self.bokeh_defaults)
        self.audio_state.update(self.audio_defaults)
        self.quality_change(self.quality["level"])

        # Apply the preset sections.
        self.state.update(preset.get("state", {}))
        self.reset_spawner.uniforms.update(preset.get("spawn", {}))
        self.color_proxy.update(
            {k: (list(v) if isinstance(v, list) else v)
             for k, v in preset.get("colors", {}).items()})
        if "fade_alpha_min_decay" in preset:
            self.color_proxy["fadeAlpha"] = max(
                self.state["flowDecay"], preset["fade_alpha_min_decay"])
        self.blend_proxy.update(preset.get("blend", {}))
        for k, v in preset.get("audio_scale", {}).items():
            self.audio_state[k] = self.audio_defaults[k] * v
        self.audio_state.update(preset.get("audio", {}))
        self.optical_flow_state.update(preset.get("optical", {}))
        if "reflow" in preset:
            self.flow_pixel_state["scale"] = preset["reflow"]
        self.blur_state.update(preset.get("blur", {}))
        self.bokeh_state.update(preset.get("bokeh", {}))
        if "base" in preset:
            self.toggle_base(preset["base"])

        self._convert_colors()

        for action in preset.get("actions", []):
            if action == "spawnImageBoth":  # Funhouse — demo.main.js:1779-81
                self.spawn_image(None)
                self.spawn_targets["spawnImage"] = "targets"
                self.spawn_image("targets")
            else:
                getattr(self, {
                    "clear": "clear", "restart": "restart",
                    "respawn": "respawn", "spawnSamples": "spawn_samples",
                    "spawnImageTargets": "spawn_image_targets",
                }[action])()

        self.preset_auto["current"] = list(PRESETS).index(name)
        return self

    def _preset_autoloop(self, dt):
        """Ref `demo.main.js:3273-3289`."""
        loop = self.preset_auto["loop"]
        if not loop:
            return
        self.preset_auto["elapsed"] += dt
        if self.preset_auto["elapsed"] >= loop:
            self.preset_auto["elapsed"] = 0.0
            names = list(PRESETS)
            nxt = (self.preset_auto["current"] + 1) % len(names)
            self.apply_preset(names[nxt])

    # -- the main loop (ref demo.main.js:1024-1161)

    def render(self):
        app = self.timer["app"]
        dt = app.tick().dt
        self.player["app"].play(app.time)

        if self.track_playing:
            self.timer["track"].tick(app.time)
            if self.app_settings["animate"]:
                self.player["track"].play(self.timer["track"].time)
            if hasattr(self.track_analyser, "tick"):
                self.track_analyser.tick(self.timer["track"].time)

        self._preset_autoloop(dt)

        # Audio sampling + response.
        self.track_texture.frequencies(self.track_trigger.data_order(0))
        self.track_trigger.sample(dt or 1)
        self.mic_texture.frequencies(self.mic_trigger.data_order(0))
        self.mic_trigger.sample(dt or 1)
        self.audio_response()

        # The whole device-side frame — colour-map blend
        # (ref demo.main.js:1070-1079), step + draw (:1082), pointer flow
        # lines (:1107-1122), optical flow (:1131-1160), vignette-blur post
        # (:1084-1102) — in ONE dispatch via `engine.step_draw_io`.
        draw_video = (self.app_settings["useMedia"]
                      and self.app_settings["useCamera"]
                      and self._video_frame is not None)
        mic_grid = self.mic_texture.grid()
        track_grid = self.track_texture.grid()
        video_grid = (self._video_frame if draw_video
                      else self.image_spawners["direct"].buffer)
        alphas = [self.blend_proxy[k] for k in self.blend_keys]

        segments = None
        self.flow_inputs.trim(1.0 / max(self.state["flowDecay"], 1e-9),
                              app.time)
        if self.app_settings["pointerFlow"]:
            segments = self.flow_inputs.segments(
                app.time, self._host_view_size(),
                self.tendrils.config.flow_shape)

        of_frames = None
        of_uniforms = None
        if draw_video and self.optical_flow_state["speed"]:
            self.optical_flow.set_pixels(self._video_frame)
            of_frames = self.optical_flow.device_buffers()
            of_uniforms = self.optical_flow_state

        self.screen = self.tendrils.step_draw_io(
            color_maps=(mic_grid, track_grid, video_grid),
            color_alphas=alphas, segments=segments,
            of_frames=of_frames, of_uniforms=of_uniforms,
            blur=(self.blur_state["radius"], self.blur_state["limit"]),
            bokeh=((self.bokeh_state["radius"], self.bokeh_state["amount"])
                   if self.bokeh_state["radius"] > 0 else None))

        self.tendrils.step_buffers()
        if of_frames is not None:
            self.optical_flow.step()

        self.frame_count += 1
        return self

    def frame(self):
        return self.render()

    @property
    def screen_image(self):
        """Post-processed output `f32[H, W, 4]`, row 0 top (a tensor on the
        engine's device; torch has no negative step, hence the flip)."""
        src = self.screen if self.screen is not None else \
            self.tendrils.sim.view[0]
        return src.permute(1, 2, 0).flip(0)

    # -- exported API — ref demo.main.js:3597-3624

    @property
    def controls(self):
        return {
            "clear": self.clear, "clearView": self.clear_view,
            "clearFlow": self.clear_flow, "respawn": self.respawn,
            "spawnSamples": self.spawn_samples,
            "spawnImage": self.spawn_image, "spawnFlow": self.spawn_flow,
            "spawnFastest": self.spawn_fastest, "spawnForm": self.spawn_form,
            "spawnImageTargets": self.spawn_image_targets,
            "reset": self.reset, "restart": self.restart,
            "toggleBase": self.toggle_base,
        }

    @property
    def presets(self):
        return {name: (lambda n=name: self.apply_preset(n))
                for name in PRESETS}


def tendrils_demo(settings=None, **kw):
    """Default-export equivalent of `demo.main.js:70`."""
    return TendrilsDemo(settings, **kw)
