"""The fade/fill pass and premultiplication of the render.

Mirrors `tendrils_tpu/ops/render.py` for what the fused draw's XLA resolve
tail needs: `fade_fill` (`drawFade`/`drawFill`, `src/index.js:342-356` +
`src/screen/index.frag`), the full-screen alpha-blended fill with
`fadeColor` that decays the trails, and `pre_alpha`. The per-particle
colour model (`particle_colors`) belongs to the generic draw and is not
ported yet (ROADMAP.md queue 1, item 4); the fused draw computes it in K1
or K2.
"""

import torch


def pre_alpha(rgb, a):
    """Premultiply — ref `src/utils/pre-alpha.glsl`. rgb `f32[3, N]`, a
    `f32[N]`."""
    return torch.cat([rgb * a[None], a[None]])


def fade_fill(view, color):
    """Alpha-blend a constant colour over a grid — ref `src/index.js:350-356`.

    `view: f32[4, H, W]`, `color: f32[4]`. The reference skips the pass when
    `fadeColor[3] <= 0` (`src/index.js:343`); blending with a = 0 is the same
    no-op, so the blend runs unconditionally (no device value is read)."""
    a = color[3]
    return color[:, None, None] * a + view * (1.0 - a)
