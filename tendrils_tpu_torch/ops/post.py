"""Screen-space compositing: copy and the weighted blends.

Mirrors the blend half of `tendrils_tpu/ops/post.py` (ref
`src/screen/blend/index.js` + `blend/main.frag`, `src/blend/*.glsl`), which
the interactive frame uses to blend its colour maps. The vignette blur and
the bokeh stack are not ported yet (ROADMAP.md queue 1, item 9).
"""

import torch


def copy(view):
    """FBO blit — ref `src/screen/copy.frag` (FXAA disabled there too)."""
    return view


def blend(views, alphas):
    """Premultiplied weighted sum of views — ref `screen/blend/main.frag:
    17-29` + `src/blend/sum.glsl`. `views`: sequence of `f32[4, H, W]`;
    `alphas`: `f32[N]` (a tensor or numbers)."""
    out = torch.zeros_like(views[0])
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        out = out + torch.cat([v[:3] * a[None], a[None]])
    return out


def blend_multiply(views, alphas):
    """`src/blend/multiply.glsl` variant: running premultiplied product."""
    out = None
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        pre = torch.cat([v[:3] * a[None], a[None]])
        out = pre if out is None else out * pre
    return out
