"""Simplex 3D noise (Ashima Arts / Stefan Gustavson `webgl-noise`).

The reference's wander force (`src/logic.frag:36,62-68`). The same
component-wise arithmetic as `tendrils_tpu/ops/noise.py`: floor, abs, mul
and add only, so it runs as plain elementwise tensor code.
"""

import torch


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _step(a, b):
    """`(a >= b)` as f32."""
    return (a >= b).to(torch.float32)


def snoise3_xyz(vx, vy, vz):
    """Simplex 3D noise over component tensors `f32[...]` -> `f32[...]`."""
    c_x = 1.0 / 6.0
    c_y = 1.0 / 3.0

    # First corner
    s = (vx + vy + vz) * c_y
    ix = torch.floor(vx + s)
    iy = torch.floor(vy + s)
    iz = torch.floor(vz + s)
    t = (ix + iy + iz) * c_x
    x0x = vx - ix + t
    x0y = vy - iy + t
    x0z = vz - iz + t

    # Other corners: g = step(x0.yzx, x0.xyz); l = 1 - g;
    # i1 = min(g, l.zxy); i2 = max(g, l.zxy).
    gx = _step(x0x, x0y)
    gy = _step(x0y, x0z)
    gz = _step(x0z, x0x)
    lx = 1.0 - gx
    ly = 1.0 - gy
    lz = 1.0 - gz
    i1x = torch.minimum(gx, lz)
    i1y = torch.minimum(gy, lx)
    i1z = torch.minimum(gz, ly)
    i2x = torch.maximum(gx, lz)
    i2y = torch.maximum(gy, lx)
    i2z = torch.maximum(gz, ly)

    x1x = x0x - i1x + c_x
    x1y = x0y - i1y + c_x
    x1z = x0z - i1z + c_x
    x2x = x0x - i2x + c_y
    x2y = x0y - i2y + c_y
    x2z = x0z - i2z + c_y
    x3x = x0x - 0.5
    x3y = x0y - 0.5
    x3z = x0z - 0.5

    # Permutations (4 corners).
    ix = _mod289(ix)
    iy = _mod289(iy)
    iz = _mod289(iz)

    def corner_perm(az, ay, ax):
        return _permute(_permute(_permute(iz + az) + iy + ay) + ix + ax)

    p0 = corner_perm(0.0, 0.0, 0.0)
    p1 = corner_perm(i1z, i1y, i1x)
    p2 = corner_perm(i2z, i2y, i2x)
    p3 = corner_perm(1.0, 1.0, 1.0)

    # Gradients: 7x7 points over a square, mapped onto an octahedron.
    # (f32 constants, as the JAX module's `jnp.float32(...)`.)
    ns_x = float(torch.tensor(2.0 / 7.0, dtype=torch.float32))
    ns_y = float(torch.tensor(0.5 / 7.0 - 1.0, dtype=torch.float32))
    ns_z = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))
    ns_zz = float(torch.tensor(ns_z, dtype=torch.float32)
                  * torch.tensor(ns_z, dtype=torch.float32))

    def gradient(p, xc, yc, zc):
        j = p - 49.0 * torch.floor(p * ns_zz)
        x_ = torch.floor(j * ns_z)
        y_ = torch.floor(j - 7.0 * x_)
        x = x_ * ns_x + ns_y
        y = y_ * ns_x + ns_y
        h = 1.0 - torch.abs(x) - torch.abs(y)
        sx = torch.floor(x) * 2.0 + 1.0
        sy = torch.floor(y) * 2.0 + 1.0
        sh = -(h <= 0.0).to(torch.float32)
        ax = x + sx * sh
        ay = y + sy * sh
        norm = _taylor_inv_sqrt(ax * ax + ay * ay + h * h)
        return (ax * norm) * xc + (ay * norm) * yc + (h * norm) * zc

    d0 = gradient(p0, x0x, x0y, x0z)
    d1 = gradient(p1, x1x, x1y, x1z)
    d2 = gradient(p2, x2x, x2y, x2z)
    d3 = gradient(p3, x3x, x3y, x3z)

    def falloff(xx, yy, zz):
        m = torch.clamp(0.6 - (xx * xx + yy * yy + zz * zz), min=0.0)
        m = m * m
        return m * m

    return 42.0 * (falloff(x0x, x0y, x0z) * d0
                   + falloff(x1x, x1y, x1z) * d1
                   + falloff(x2x, x2y, x2z) * d2
                   + falloff(x3x, x3y, x3z) * d3)
