"""Per-particle render colour model and the fade/fill pass.

Mirrors `tendrils_tpu/ops/render.py`. `particle_colors` is the vertex
colour math of `src/render/index.vert:57-100`: base colour + colour-map
lookup + velocity-direction->RGB alignment on three axes at 120 degrees,
each premultiplied and clamped, then summed; alpha scaled by speed and a
radial bezier vignette. The generic draw splats these colours into the
view (GL `SRC_ALPHA, ONE_MINUS_SRC_ALPHA`, ref `src/index.js:268`); the
fused draw computes the same model in K1 or K2. `fade_fill` is the
full-screen alpha-blended fill with `fadeColor` that decays the trails
(`drawFade`/`drawFill`, `src/index.js:342-356` + `src/screen/index.frag`).
"""

import torch

from . import sample
from .filters import vignette

# Pre-generated flow axes — ref `src/render/index.vert:33-36`
# (angleToVec(0), angleToVec(tau/3), angleToVec(2*tau/3)).
_FLOW_AXIS = (
    (1.0, 0.0),
    (-0.5000000000000004, -0.8660254037844385),
    (-0.4999999999999998, 0.8660254037844387),
)
# ref `src/render/index.vert:44-46`
_FADE_RANGE = (0.2, 1.0)
_FALLOFF = (0.2, 1.0, 1.0)


def pre_alpha(rgb, a):
    """Premultiply — ref `src/utils/pre-alpha.glsl`. rgb `f32[3, N]`, a
    `f32[N]`."""
    return torch.cat([rgb * a[None], a[None]])


def particle_colors(pos, vel, colormap_uv, color_map, params, time):
    """Per-particle RGBA — ref `src/render/index.vert:57-94`. `pos`, `vel`:
    `f32[2, N]`; `colormap_uv`: `f32[2, N]` (the draw-geometry UV);
    `color_map`: `f32[4, h, w]`. Returns `f32[4, N]`."""
    vel_n = vel / params["speedLimit"]
    # speedAlpha = 0 means "saturate immediately"; guard the 0/0.
    speed_rate = torch.clamp(
        (vel_n[0] ** 2 + vel_n[1] ** 2)
        / torch.clamp(params["speedAlpha"], min=1e-12), max=1.0)
    mapped = sample.sample_uv(color_map, colormap_uv.T) \
        * params["colorMapAlpha"]
    # Flow-alignment colour: the velocity direction projected on 3 axes at
    # 120 degrees, hue-rotated over time by flowDecay — ref
    # `src/render/index.vert:76-83`.
    axis = torch.tensor(_FLOW_AXIS, dtype=vel.dtype, device=vel.device)
    align = axis[:, 0:1] * vel_n[0] + axis[:, 1:2] * vel_n[1]  # [3, N]
    align_gbr = align[[1, 2, 0]]
    t = torch.sin(time * params["flowDecay"])
    mixed = align + (align_gbr * (1.0 - params["flowDecay"]) - align) * t
    flow_align = mixed * 0.5 + 0.5  # [-1, 1] -> [0, 1]
    flow_color = params["flowColor"]
    base_color = params["baseColor"]
    n = pos.shape[1]
    base_rgba = pre_alpha(base_color[:3, None].expand(3, n),
                          base_color[3].expand(n))
    mapped_rgba = pre_alpha(mapped[:3], mapped[3])
    flow_rgba = pre_alpha(flow_color[:3, None] * flow_align,
                          flow_color[3].expand(n))
    color = (torch.clamp(base_rgba, 0.0, 1.0)
             + torch.clamp(mapped_rgba, 0.0, 1.0)
             + torch.clamp(flow_rgba, 0.0, 1.0))
    # Alpha: speed rate x clamped radial vignette — ref index.vert:92-94.
    vig = vignette(pos.T, (0.0, 0.0), 1.0, _FALLOFF)
    a = color[3] * speed_rate * torch.clamp(vig, *_FADE_RANGE)
    return torch.cat([color[:3], a[None]])


def fade_fill(view, color):
    """Alpha-blend a constant colour over a grid — ref `src/index.js:350-356`.

    `view: f32[4, H, W]`, `color: f32[4]`. The reference skips the pass when
    `fadeColor[3] <= 0` (`src/index.js:343`); blending with a = 0 is the same
    no-op, so the blend runs unconditionally (no device value is read)."""
    a = color[3]
    return color[:, None, None] * a + view * (1.0 - a)
