"""Spawn ops — pure functions producing new particle (or target) state
`f32[4, N]`.

The port of `tendrils_tpu/ops/spawn.py` (the reference's `src/spawn/`):
each spawner is a function the engine applies to the particle ping-pong or
to the targets buffer (`Tendrils.spawn_shader`).

  - `init`: all inert — `src/spawn/init/index.frag`.
  - `ball`: uniform random disc from the fractional-sine hash —
    `src/spawn/ball/index.frag:8-18`; `ball_random` the same disc from a
    `torch.Generator` (`src/spawn/ball/cpu.js`).
  - `pixels_direct`: each particle from its own texel —
    `src/spawn/pixels/frag/direct-main.frag`.
  - `pixels_best_sample`: stochastic best-of-N candidates —
    `src/spawn/pixels/frag/best-sample-main.frag:22-45`.
  - the apply and test plugins — `src/spawn/pixels/{apply,test}/*.glsl`.
  - `shuffle_triangles`, `rasterize_triangles`: the geometry spawner's
    random triangle fans, rasterised to a small grid —
    `src/spawn/geometry/index.js:54-111`.

All plain torch: the JAX functions are XLA under `jit` with no Pallas
kernel behind them. Where the JAX package takes a threefry key
(`ball_random`, `shuffle_triangles`) the port takes a `torch.Generator`;
the two streams differ, so the tests hold them by bounds and moments.
"""

import torch

from ..const import INERT, TAU
from . import coords, sample
from .filters import vignette
from .rand import glsl_random, mod

_TAU = float(TAU)


def angle_to_vec(rad):
    """Ref `src/utils/angle-to-vec.glsl`. `f32[...]` -> `f32[..., 2]`."""
    return torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)


def init(particles):
    """All particles inert — ref `src/spawn/init/index.frag`."""
    n = particles.shape[1]
    f32 = dict(dtype=torch.float32, device=particles.device)
    return torch.cat([torch.full((2, n), float(INERT), **f32),
                      torch.zeros((2, n), **f32)])


def ball(particles, frag_xy, radius, speed):
    """Uniform random disc — ref `src/spawn/ball/index.frag:8-18`.

    `frag_xy`: `f32[2, N]` data-texture frag coords (texel centres), the
    coords the fragment shader hashes, so respawn is deterministic per
    particle like the reference."""
    del particles
    fx = frag_xy.T  # [N, 2]
    r = torch.stack([
        glsl_random(fx * 1.7654 + 2.3675),
        glsl_random(fx * 1.23494 + 0.36434),
        glsl_random(fx * 0.327789 + 3.498787),
        glsl_random(fx * 9.0374 + 0.2773)])
    pos = angle_to_vec(r[0] * _TAU).T * (r[1] * radius)
    vel = angle_to_vec(r[2] * _TAU).T * (r[3] * speed)
    return torch.cat([pos, vel])


def ball_random(particles, generator, radius=1.0, speed=0.01):
    """The ball spawn with a fresh random stream each call — ref
    `src/spawn/ball/cpu.js` (`Math.random`, so successive respawns
    differ). `generator`: a `torch.Generator` on the particles' device
    (`Tendrils.generator`)."""
    n = particles.shape[1]
    r = torch.rand((4, n), generator=generator, dtype=torch.float32,
                   device=particles.device)
    pos = angle_to_vec(r[0] * _TAU).T * (r[1] * radius)
    vel = angle_to_vec(r[2] * _TAU).T * (r[3] * speed)
    return torch.cat([pos, vel])


# --- Pixel spawners -------------------------------------------------------

def spawn_to_pos(uv, spawn_matrix, spawn_size, jitter, time, seed_uv=None):
    """UV -> spawn position — ref `src/spawn/pixels/frag/head.frag:27-37`.

    Jitters around the UV cell (hiding boxy scaled-sampling artefacts),
    flips Y, scales by `spawn_size` and applies the 3x3 `spawn_matrix`.
    `uv`: `f32[N, 2]`; `time` a 0-d f32 tensor; returns `f32[N, 2]`."""
    if seed_uv is None:
        seed_uv = uv
    jx = glsl_random(seed_uv - 1.2345 + time * 0.001)
    jy = glsl_random(seed_uv + 1.2345 + time * 0.001)
    off = torch.stack([
        -jitter[0] + 2.0 * jitter[0] * jx,
        -jitter[1] + 2.0 * jitter[1] * jy], dim=-1)
    p = coords.uv_to_pos(uv + off)
    # The Y flip: a negation, exactly the JAX function's `* (1, -1)`.
    p = torch.stack([p[..., 0], -p[..., 1]], dim=-1) * spawn_size
    m = spawn_matrix
    return torch.stack([
        m[0, 0] * p[..., 0] + m[0, 1] * p[..., 1] + m[0, 2],
        m[1, 0] * p[..., 0] + m[1, 1] * p[..., 1] + m[1, 2]], dim=-1)


# apply(uv, pos, pixel) plugins: `pixel` is `f32[4, N]`, `pos`/`uv`
# `f32[N, 2]`; each returns a candidate state `f32[4, N]`.

def apply_color(uv, pos, pixel, *, time=0.0, **_):
    """Hue -> direction via HSV — ref
    `src/spawn/pixels/apply/color.glsl:12-17`."""
    h, s, v = rgb_to_hsv(pixel[0], pixel[1], pixel[2])
    vel = angle_to_vec((h + time * 0.00003) * _TAU).T * (s * v * pixel[3])
    return torch.cat([pos.T, vel])


def apply_brightest(uv, pos, pixel, **_):
    """Luma -> speed, random direction — ref
    `spawn/pixels/apply/brightest.glsl`."""
    lum = luma(pixel)
    rnd = glsl_random(uv * torch.sum(pixel[:2] * pixel[2:], dim=0)[:, None])
    vel = angle_to_vec(mod(rnd, 1.0) * _TAU).T * (lum * pixel[3])
    return torch.cat([pos.T, vel])


def apply_flow(uv, pos, pixel, *, time=0.0, decay=0.0, **_):
    """Reuse the flow payload — ref `src/spawn/pixels/apply/flow.glsl`."""
    age = torch.clamp(1.0 - (time - pixel[2]) * decay, min=0.0)
    return torch.cat([pos.T, pixel[:2] * age])


def apply_particles(uv, pos, pixel, **_):
    """Pixel pos + particle-format vel — ref
    `spawn/pixels/apply/particles.glsl`."""
    return torch.cat([pos.T, pixel[2:]])


def apply_simple(uv, pos, pixel, **_):
    """Vel encoded in yz — ref `src/spawn/pixels/apply/simple.glsl`."""
    return torch.cat([pos.T, pixel[1:3]])


def apply_identity(uv, pos, pixel, **_):
    """Ref `src/spawn/pixels/apply/identity.glsl`."""
    return pixel


def with_vignette(apply_fn, mid=(0.5, 0.5), limit=0.6, curve=(0.1, 1.0, 1.0)):
    """Compose a vignette filter pass before apply — ref
    `src/spawn/pixels/apply/compose-filter.glsl` + `vignette-head.glsl`."""

    def composed(uv, pos, pixel, **kw):
        masked = pixel * vignette(uv, mid, limit, curve)[None]
        return apply_fn(uv, pos, masked, **kw)

    return composed


def test_particles(data):
    """Highest speed wins — ref `src/spawn/pixels/test/particles.glsl`."""
    return data[2] ** 2 + data[3] ** 2


def test_brightest(data):
    """Ref `src/spawn/pixels/test/brightest.glsl`."""
    return luma(data)


def test_simple(data):
    """Score encoded in the x channel — ref
    `src/spawn/pixels/test/simple.glsl` (whose body reads `current.x`; the
    intended semantics)."""
    return data[0]


def luma(pixel):
    """`glsl-luma`: Rec-601 luma `dot(rgb, (0.299, 0.587, 0.114))` (the
    npm package's weights, as the JAX function documents). `pixel:
    f32[4, N]` -> `f32[N]`."""
    return 0.299 * pixel[0] + 0.587 * pixel[1] + 0.114 * pixel[2]


def rgb_to_hsv(r, g, b):
    """`libs/glsl-hsv/rgb-hsv.glsl` semantics, vectorised."""
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    eps = 1e-10
    s = d / (mx + eps)
    v = mx
    rc = (mx - r) / (d + eps)
    gc = (mx - g) / (d + eps)
    bc = (mx - b) / (d + eps)
    h = torch.where(r == mx, bc - gc,
                    torch.where(g == mx, 2.0 + rc - bc, 4.0 + gc - rc))
    h = mod(h / 6.0, 1.0)
    h = torch.where(d < eps, 0.0, h)
    return h, s, v


def pixels_direct(particles, spawn_data, data_uv, *, apply_fn, speed,
                  spawn_matrix, spawn_size, jitter, time, **apply_kw):
    """Direct per-texel spawn — ref
    `spawn/pixels/frag/direct-main.frag:10-21`.

    `spawn_data`: `f32[4, H, W]` source texture; `data_uv`: `f32[N, 2]`
    the particle's data-texture UV."""
    del particles
    pos = spawn_to_pos(data_uv, spawn_matrix, spawn_size, jitter, time)
    pixel = sample.sample_uv(spawn_data, data_uv)
    st = apply_fn(data_uv, pos, pixel, time=time, **apply_kw)
    return torch.cat([st[:2], st[2:] * speed])


def pixels_best_sample(particles, spawn_data, data_uv, *, apply_fn, test_fn,
                       samples, bias, speed, spawn_matrix, spawn_size, jitter,
                       time, **apply_kw):
    """Stochastic best-of-N spawn — ref
    `frag/best-sample-main.frag:22-45`.

    Keeps the current state unless a sampled candidate scores higher than
    `bias * test(current)` (the reference keeps current where
    `test(current) > bias * test(next)`)."""
    state = particles
    base_seed = (state.T + torch.cat([data_uv, data_uv], dim=-1)
                 + (1.2345 + time * 0.001))  # [N, 4]
    for k in range(int(samples)):
        seed = base_seed + float(k)
        su = mod(glsl_random(seed[:, :2]), 1.0)
        sv = mod(glsl_random(seed[:, 2:]), 1.0)
        spawn_uv = torch.stack([su, sv], dim=-1)
        pos = spawn_to_pos(spawn_uv, spawn_matrix, spawn_size, jitter, time)
        pixel = sample.sample_uv(spawn_data, spawn_uv)
        other = apply_fn(spawn_uv, pos, pixel, time=time, **apply_kw)
        other = torch.cat([other[:2], other[2:] * speed])
        keep = test_fn(state) > bias * test_fn(other)
        state = torch.where(keep[None], state, other)
    return state


# --- Geometry spawner -----------------------------------------------------

def shuffle_triangles(generator, count=3, radii=(0.25, 1.3),
                      arcs=(1e-2, 3e-2), obtuse_rate=0.5, obtuse_pad=0.25):
    """Random triangle fan — ref `src/spawn/geometry/index.js:54-91`.

    Each triangle keeps one vertex at the origin; the other two sit at
    `angle -+ arc` with independent random radii. `generator`: a
    `torch.Generator`; the fan is made on its device. Returns
    `f32[count, 3, 2]`."""

    def u():
        return torch.rand(count, generator=generator, dtype=torch.float32,
                          device=generator.device)

    angle = u() * _TAU
    arc = _TAU * (arcs[0] + u() * arcs[1]
                  + (u() < obtuse_rate).to(torch.float32) * obtuse_pad)
    rad1 = radii[0] + u() * radii[1]
    rad2 = radii[0] + u() * radii[1]
    p1 = angle_to_vec(angle - arc) * rad1[:, None]
    p2 = angle_to_vec(angle + arc) * rad2[:, None]
    return torch.stack([torch.zeros_like(p1), p1, p2], dim=1)


def rasterize_triangles(tris, grid_hw, view_size, color=(1.0, 1.0, 1.0, 1.0)):
    """Rasterise triangles into `f32[4, H, W]` — the reference draws its
    fan into a small FBO at 0.2x view res
    (`src/spawn/geometry/index.js:94-103`).

    A dense point-in-triangle test per texel (a fan has a few triangles),
    clip coords scaled by `view_size` like `geom/vert/index.vert`. The
    grid is made on `view_size`'s device."""
    h, w = grid_hw
    dev = view_size.device
    tris = tris.to(dev)
    p = coords.uv_to_pos(coords.uv_grid((h, w), device=dev))
    inside = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for t in range(tris.shape[0]):
        a, b, c = (tris[t, 0] * view_size, tris[t, 1] * view_size,
                   tris[t, 2] * view_size)

        def edge(p0, p1):
            return ((p[..., 0] - p0[0]) * (p1[1] - p0[1])
                    - (p[..., 1] - p0[1]) * (p1[0] - p0[0]))

        e0, e1, e2 = edge(a, b), edge(b, c), edge(c, a)
        hit = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
               | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        inside = inside | hit
    col = torch.tensor(color, dtype=torch.float32, device=dev)
    return col[:, None, None] * inside[None].to(torch.float32)
