"""Small GLSL utility twins — ref `src/utils/*.glsl`, `src/geom/*.glsl`,
`libs/glsl-hsv/*`, as `tendrils_tpu/ops/glsl_utils.py`, in PyTorch.

The remaining shared shader helpers, so that every module of the
reference's GLSL corpus has a named equivalent: `length2`, `nilish`,
`perp`, `transform`, `point_in_box`, `line_sdf`, and the HSV pair (its
`rgb_to_hsv` core is the spawners', `ops/spawn.py`). Shape-generic,
vectorised over leading axes; inputs that are not tensors are taken as
f32 tensors.
"""

import torch

from ..const import EPSILON
from .spawn import rgb_to_hsv as _rgb_to_hsv


def _f32(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float32)


def length2(v):
    """Squared length — ref `src/utils/length-2.glsl`. `f32[..., D]`."""
    v = _f32(v)
    return torch.sum(v * v, dim=-1)


def nilish(v):
    """Near-zero test — ref `src/utils/nilish.glsl` (eps = 1e-9)."""
    v = _f32(v)
    if v.ndim and v.shape[-1] <= 4:
        return length2(v) <= EPSILON
    return v * v <= EPSILON


def perp(v, anti=False):
    """Perpendicular — ref `src/utils/perp.glsl`. `f32[..., 2]`."""
    v = _f32(v)
    x, y = v[..., 0], v[..., 1]
    if anti:
        return torch.stack([y, -x], dim=-1)
    return torch.stack([-y, x], dim=-1)


def transform(m, v):
    """Homogeneous transform — ref `src/utils/transform.glsl`.
    `m: f32[D+1, D+1]`, `v: f32[..., D]` -> `f32[..., D]`."""
    m, v = _f32(m), _f32(v)
    d = v.shape[-1]
    return torch.einsum("ij,...j->...i", m[:d, :d], v) + m[:d, d]


def point_in_box(point, box):
    """1.0 if inside — ref `src/geom/point-in-box.glsl`. `box: f32[4]` as
    (min.x, min.y, max.x, max.y)."""
    point, box = _f32(point), _f32(box)
    clamped = torch.minimum(torch.maximum(point, box[:2]), box[2:])
    return (length2(point - clamped) <= 0.0).to(torch.float32)


def line_sdf(p, start, end, rad):
    """Distance to a capsule segment — ref `src/geom/line/sdf.glsl`."""
    p, start, end = _f32(p), _f32(start), _f32(end)
    rel = start - p
    direction = start - end
    length = torch.sqrt(torch.sum(direction * direction, dim=-1,
                                  keepdim=True))
    direction = direction / torch.clamp(length, min=1e-12)
    proj = torch.minimum(torch.clamp(
        torch.sum(rel * direction, dim=-1, keepdim=True), min=0.0),
        length) * direction
    return torch.sqrt(length2(rel - proj)) - rad


def rgb_to_hsv(rgb):
    """`libs/glsl-hsv/rgb-hsv.glsl`. `f32[..., 3]` -> `f32[..., 3]`."""
    rgb = _f32(rgb)
    h, s, v = _rgb_to_hsv(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    """`libs/glsl-hsv/hsv-rgb.glsl`. `f32[..., 3]` -> `f32[..., 3]`."""
    hsv = _f32(hsv)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    k = torch.remainder(h[..., None] * 6.0 + torch.tensor(
        [5.0, 3.0, 1.0], dtype=hsv.dtype, device=hsv.device), 6.0)
    f = torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
    return v[..., None] * (1.0 - s[..., None] * f)
