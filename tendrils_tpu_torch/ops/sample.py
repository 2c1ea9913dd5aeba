"""Texture-style sampling of grids (the stand-in for `texture2D`).

Mirrors `tendrils_tpu/ops/sample.py`: a "texture" is `f32[C, H, W]`,
sampling is a gather + bilinear interpolation with CLAMP_TO_EDGE
semantics. `bilinear_sample` is the plain version of the bilinear-gather
kernel (`ops/gather_cuda.py`).
"""

import torch


def bilinear_sample(grid, x, y):
    """Bilinearly sample `grid: f32[C, H, W]` at texel coords `x`, `y:
    f32[N]` ((0.5, 0.5) is the centre of texel [0, 0]). Returns
    `f32[C, N]`, clamp-to-edge addressing."""
    c, h, w = grid.shape
    # CLAMP_TO_EDGE: edge samples read the edge texel (GL semantics).
    gx = torch.clamp(x, 0.5, w - 0.5) - 0.5
    gy = torch.clamp(y, 0.5, h - 0.5) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0

    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)

    flat = grid.reshape(c, h * w)
    v00 = flat[:, y0i * w + x0i]
    v01 = flat[:, y0i * w + x1i]
    v10 = flat[:, y1i * w + x0i]
    v11 = flat[:, y1i * w + x1i]

    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def sample_uv(grid, uv):
    """Bilinearly sample `grid: f32[C, H, W]` at `uv: f32[N, 2]` in [0,1]
    -> `f32[C, N]`."""
    _, h, w = grid.shape
    return bilinear_sample(grid, uv[..., 0] * w, uv[..., 1] * h)
