"""Optical flow from video frames — ref `src/optical-flow/index.frag:55-81`.

Mirrors `tendrils_tpu/ops/optical_flow.py`: central-difference x/y
gradients summed over the current and last frames (grayscale), then

    vec = (diff·gradX/|grad|, diff·gradY/|grad|) · speed
    out = flow_payload(bezier((0,0,1), |vec|/speedLimit) · vec, speedLimit)

The sampling offset is a fractional-pixel translation (a roll + linear
blend). The JAX function rolls by device scalars; `torch.roll` takes host
integers, so here `offset`, `lambda_` and `speed` are host numbers and the
integer and fractional parts of `offset·size` are computed on the host in
f32, as the JAX function computes them on the device: no frame reads a
device value back.
"""

import math

import numpy as np
import torch

from . import flow as flow_ops


def gray_scale(img):
    """Luma (0.3, 0.59, 0.11) — ref `src/utils/gray-scale.glsl`.
    `img: f32[4, H, W]` -> `f32[H, W]`."""
    return 0.3 * img[0] + 0.59 * img[1] + 0.11 * img[2]


def _split(d):
    """f32 `d` -> (floor as int, f32 fraction), as the JAX `_translate`
    splits its traced shift."""
    d = np.float32(d)
    i = math.floor(d)
    return i, float(d - np.float32(i))


def _translate(img, dx, dy):
    """Translate `f32[H, W]` by host fractional pixels `dx`, `dy` (+x
    right, +y up in texel space, so array shifts are negative)."""
    ix, fx = _split(dx)
    iy, fy = _split(dy)

    def roll2(a, sx, sy):
        return torch.roll(torch.roll(a, -sx, dims=1), -sy, dims=0)

    a = roll2(img, ix, iy)
    b = roll2(img, ix + 1, iy)
    c = roll2(img, ix, iy + 1)
    d = roll2(img, ix + 1, iy + 1)
    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    return top + (bot - top) * fy


def optical_flow(view, last, time, offset=0.1, lambda_=0.001, speed=1.0,
                 speed_limit=1.0):
    """Flow payload grid `f32[4, H, W]` from two frames `view`, `last`
    (`f32` or `u8[4, H, W]`; u8 is normalised to [0, 1] on the device).
    `offset` (UV units), `lambda_` and `speed` are host numbers; `time`
    and `speed_limit` numbers or 0-d tensors."""
    if view.dtype == torch.uint8:
        view = view.to(torch.float32) * (1.0 / 255.0)
    if last.dtype == torch.uint8:
        last = last.to(torch.float32) * (1.0 / 255.0)
    _, h, w = view.shape
    gv = gray_scale(view)
    gl = gray_scale(last)
    # offset * size in f32, as the JAX function multiplies its f32 scalar.
    ox = np.float32(offset) * np.float32(w)
    oy = np.float32(offset) * np.float32(h)

    def grad(img_a, img_b, dx, dy):
        return (_translate(img_a, dx, dy) - _translate(img_a, -dx, -dy)
                + _translate(img_b, dx, dy) - _translate(img_b, -dx, -dy))

    grad_x = grad(gv, gl, ox, 0.0)
    grad_y = grad(gv, gl, 0.0, oy)
    grad_mag = torch.sqrt(grad_x * grad_x + grad_y * grad_y + lambda_)
    diff = gv - gl
    vx = diff * grad_x / grad_mag * speed
    vy = diff * grad_y / grad_mag * speed
    # bezier((0,0,1), t) = t² falloff — ref index.frag:80; t is unclamped.
    mag = torch.sqrt(vx * vx + vy * vy)
    t = mag / torch.clamp(torch.as_tensor(speed_limit, dtype=torch.float32,
                                          device=view.device), min=1e-12)
    fall = t * t
    vel = torch.stack([vx * fall, vy * fall])
    return flow_ops.flow_payload(vel.reshape(2, -1), time,
                                 speed_limit).reshape(4, h, w)


def composite_flow(flow_grid, payload):
    """Alpha-blend a flow payload over the flow grid (`SRC_ALPHA,
    ONE_MINUS_SRC_ALPHA`, `demo.main.js:1150-1156`)."""
    a = payload[3:4]
    return payload * a + flow_grid * (1.0 - a)
