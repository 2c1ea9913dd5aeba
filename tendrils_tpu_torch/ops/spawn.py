"""Spawn ops — pure functions producing new particle state `f32[4, N]`.

The slice's spawners from `tendrils_tpu/ops/spawn.py`: `init` (all inert,
`src/spawn/init/index.frag`) and `ball` (uniform random disc from the
fractional-sine hash, `src/spawn/ball/index.frag:8-18`). The pixel and
geometry spawners are still to be ported (ROADMAP queue 1, item 8).
"""

import torch

from ..const import INERT, TAU
from .rand import glsl_random


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
    pos = angle_to_vec(r[0] * float(TAU)).T * (r[1] * radius)
    vel = angle_to_vec(r[2] * float(TAU)).T * (r[3] * speed)
    return torch.cat([pos, vel])
