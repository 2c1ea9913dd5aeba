"""Coordinate maps between particle space, UV space and grid pixels.

Mirrors `tendrils_tpu/ops/coords.py` (the reference's `src/map/*.glsl` and
`src/utils/aspect.js`). Grid convention: arrays are indexed `[row=y, col=x]`
with row 0 at clip y = -1.
"""

import numpy as np
import torch


def pos_to_uv(pos):
    """NDC [-1,1] -> UV [0,1]. Ref `src/map/pos-to-uv.glsl`."""
    return pos * 0.5 + 0.5


def uv_to_pos(uv):
    """UV [0,1] -> NDC [-1,1]. Ref `src/map/uv-to-pos.glsl`."""
    return uv * 2.0 - 1.0


def aspect(size, scale):
    """`scale / size` — ref `src/utils/aspect.js:6-7` (host numpy)."""
    size = np.asarray(size, np.float32)
    return np.float32(scale) / size


def cover_aspect(size):
    """`max(size) / size` — ref `src/utils/aspect.js:12-13`."""
    return aspect(size, max(size))


def clip_to_pixel(p_clip, view_res):
    """Clip-space `f32[..., 2]` -> window pixel coords `f32[..., 2]`
    (`view_res` is (W, H); pixel centre k sits at k + 0.5)."""
    w, h = view_res
    x = (p_clip[..., 0] * 0.5 + 0.5) * w
    y = (p_clip[..., 1] * 0.5 + 0.5) * h
    return torch.stack([x, y], dim=-1)


def uv_grid(shape, dtype=torch.float32, device=None):
    """Per-texel UVs of a `[h, w]` grid at pixel centres, `f32[h, w, 2]`:
    `gl_FragCoord.xy / res` (the logic shader's `uv`,
    `src/logic.frag:46`)."""
    h, w = shape
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([u, v], dim=-1)
