"""Scalar filter utilities: bezier falloff curves and vignettes.

Mirrors `tendrils_tpu/ops/filters.py`: `src/utils/bezier.glsl` (1-4
control-point bezier evaluation) and `src/filter/vignette.glsl` (radial
falloff shaped by a bezier curve), used by the blur and bokeh posts.
Control points and centres take the dtype and device of the tensor they
are evaluated at.
"""

import torch


def _like(v, t):
    return torch.as_tensor(v, dtype=t.dtype, device=t.device)


def bezier(cp, t):
    """Evaluate a bezier with 1-4 control points — ref
    `src/utils/bezier.glsl`. `cp`: 1-4 scalars (a sequence or a tensor);
    `t`: a tensor."""
    cp = _like(cp, t)
    k = cp.shape[-1] if cp.ndim else 1
    if cp.ndim == 0 or k == 1:
        return cp.reshape(-1)[0].expand(t.shape)
    if k == 2:
        return cp[0] + (cp[1] - cp[0]) * t
    if k == 3:
        ut = 1.0 - t
        return (cp[0] * ut + cp[1] * t) * ut + (cp[1] * ut + cp[2] * t) * t
    if k == 4:
        ut = 1.0 - t
        a1 = cp[1] * ut + cp[2] * t
        return (((cp[0] * ut + cp[1] * t) * ut + a1 * t) * ut
                + (a1 * ut + (cp[2] * ut + cp[3] * t) * t) * t)
    raise ValueError("bezier supports 1-4 control points")


def vignette_amount(point, mid, limit):
    """`min(1 - |point - mid| / limit, 1)` — ref
    `src/filter/vignette.glsl:5-7`. `point`: `f32[..., 2]`; returns
    `f32[...]`."""
    d = torch.sqrt(torch.sum((point - _like(mid, point)) ** 2, dim=-1))
    return torch.clamp(1.0 - d / limit, max=1.0)


def vignette(point, mid, limit, curve=None):
    """Radial falloff, optionally bezier-shaped — ref
    `src/filter/vignette.glsl`."""
    amt = vignette_amount(point, mid, limit)
    if curve is None:
        return torch.clamp(amt, min=0.0)
    curve = _like(curve, amt)
    if curve.ndim == 0:
        return torch.clamp(curve * amt, min=0.0)
    return torch.clamp(bezier(curve, amt), min=0.0)


def vignette_pass(uv, pixel, mid, limit, curve):
    """Vignette as a pixel filter — ref
    `src/filter/pass/vignette.glsl:9-13`. `uv`: `f32[..., 2]`, `pixel`:
    `f32[C, ...]`; multiplies the pixel by the vignette value at its uv."""
    return pixel * vignette(uv, mid, limit, curve)
