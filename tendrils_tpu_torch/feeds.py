"""Synthetic inputs of the interactive frame (`Tendrils.step_draw_io`):
the moving-bar camera of `bench.py`'s config-4 line, pointers moving on
circles and, optionally, the demo's three colour maps, fed the way the
demo app feeds them (one camera upload and one pointer sample a frame, the
pointer paths trimmed to the last 1/flowDecay ms as
`tendrils_tpu/app/demo.py:633` trims them, the colour maps passed every
frame as `demo.py:626-653` passes them). Used by `chip_smoke.py` and
`frame_profile.py`.
"""

import math

import numpy as np

from .flow_line import FlowLines
from .media import OpticalFlow, image_to_grid
from .ops import coords

DT = 1000.0 / 60.0
OF_UNIFORMS = {"offset": 0.05, "speed": 0.08}
# The demo's colour-map blend weights, mic / track / video
# (`tendrils_tpu/app/demo.py:152-153`).
COLOR_ALPHAS = (0.1, 0.3, 0.8)
# The demo's vignette blur, `(radius, limit)` (`app/demo.py:157-158`).
DEMO_BLUR = (5.0, 0.4)
AUDIO_BINS = 512  # frequency bins of the demo's 1024-point analysers


def camera_frame(i):
    """Camera frame `i`: 480x640 u8, a 40-px white bar moving 8 px a
    frame (`bench.py:233-242`)."""
    img = np.zeros((480, 640, 3), np.uint8)
    img[:, (i * 8) % 600:(i * 8) % 600 + 40] = 255
    return img


def add_pointer_points(lines, n_pointers, t):
    """One sample at time `t` (ms) of each pointer, on circles of radius
    0.3, 0.4, ... in clip space."""
    for p in range(n_pointers):
        a = 0.004 * t + p * math.pi / 2
        r = 0.3 + 0.1 * p
        lines.get(p).add(t, (r * math.cos(a), r * math.sin(a)))


def trail_ms(flow_decay):
    """How long a pointer's path is painted: 1/flowDecay ms, the demo's
    trim (`tendrils_tpu/app/demo.py:633`); 200 ms at the default 0.005."""
    return 1.0 / max(float(flow_decay), 1e-9)


def pointer_lines(n_pointers, t_end, trail):
    """FlowLines of `n_pointers` pointers, one sample a frame up to time
    `t_end` (ms), trimmed to the last `trail` ms."""
    lines = FlowLines()
    for k in range(int(trail / DT) + 2, -1, -1):
        add_pointer_points(lines, n_pointers, t_end - k * DT)
    lines.trim(trail, t_end)
    return lines


def audio_texture(rng):
    """A synthetic audio texture as the demo's colour map: `f32[4, 1,
    AUDIO_BINS]`, a spectrum in [0, 1] replicated to RGB with alpha 1
    (`tendrils_tpu/audio/texture.py:42-48`)."""
    v = rng.uniform(0.0, 1.0, (1, 1, AUDIO_BINS)).astype(np.float32)
    return np.concatenate([v, v, v, np.ones_like(v)])


class IoFeed:
    """The config-4 inputs of one engine: a camera ring on its device and
    4 pointer paths, fed to `step_draw_io` once a frame. With
    `color_maps`, also the demo's three colour maps every frame: two
    synthetic audio textures (mic and track, made from `seed`) and the
    camera frame's grid, blended 0.1 / 0.3 / 0.8. With `blur` (`(radius,
    limit)`; the demo's is `DEMO_BLUR`), the post stage's vignette blur
    every frame."""

    def __init__(self, eng, n_pointers=4, color_maps=False, seed=0,
                 blur=None):
        self.eng = eng
        self.blur = blur
        rng = np.random.default_rng(seed)
        self.audio = ((audio_texture(rng), audio_texture(rng)) if color_maps
                      else None)
        self.ring = OpticalFlow(OF_UNIFORMS, device=eng.device)
        self.n_pointers = n_pointers
        self.lines = pointer_lines(n_pointers, eng.timer.time,
                                   trail_ms(eng.state["flowDecay"]))
        h, w = eng.config.view_res
        self.view_size = coords.cover_aspect((w, h))

    def frame(self, i):
        """Camera frame `i` and a pointer sample, then one io frame; returns
        its screen (None without `blur`)."""
        eng = self.eng
        frame = camera_frame(i)
        self.ring.set_pixels(frame)
        eng.timer.tick()
        add_pointer_points(self.lines, self.n_pointers, eng.timer.time)
        self.lines.trim(trail_ms(eng.state["flowDecay"]), eng.timer.time)
        maps = None
        if self.audio is not None:
            maps = (*self.audio, image_to_grid(frame))
        screen = eng.step_draw_io(
            color_maps=maps, color_alphas=COLOR_ALPHAS,
            segments=self.lines.segments(eng.timer.time, self.view_size,
                                         eng.config.flow_shape),
            of_frames=self.ring.device_buffers(), of_uniforms=OF_UNIFORMS,
            blur=self.blur)
        self.ring.step()
        return screen
