"""The particle logic step — `src/logic.frag:45-101`, as in
`tendrils_tpu/ops/logic.py`: per particle,
  1. simplex-noise wander force at `(pos * noiseScale, uv + time * noiseSpeed)`
  2. flow-field force sampled at the particle's screen position, decayed
  3. weighted accumulation with damping: `vel*damping*dt + forceWeight*(...)`
  4. target-seek force `(target - pos) * target`
  5. speed clamp to `speedLimit`, Euler integrate `pos += vel`
with per-particle variance `vary(base, i, variance) = base + i*variance*base`
and the inert-sentinel mask. Plain elementwise tensor code (the JAX package
leaves it to XLA too: no TPU kernel sits on this step).
"""

import torch

from ..const import INERT
from . import flow as flow_ops
from .noise import snoise3_xyz


def vary(base, offset, variance):
    """Per-particle parameter variance — ref `src/logic.frag:41-43`."""
    return base + (offset * variance * base)


def wander_force(pos, uv, index01, params, time):
    """Simplex wander force — ref `src/logic.frag:60-68`. `f32[2, N]`."""
    noise_scale = vary(params["noiseScale"], index01, params["varyNoiseScale"])
    noise_speed = vary(params["noiseSpeed"], index01, params["varyNoiseSpeed"])
    noise_pos = pos * noise_scale  # [2, N]
    noise_time = time * noise_speed
    za = uv[0] + noise_time
    zb = uv[1] + noise_time + 1234.5678
    return torch.stack([snoise3_xyz(noise_pos[0], noise_pos[1], za),
                        snoise3_xyz(noise_pos[0], noise_pos[1], zb)])


def step_particles(particles, flows, targets, params, uv, index01, view_size,
                   time, dt, sample_fn=None, flow_force_fn=None):
    """One logic step: `f32[4, N]` -> `f32[4, N]`. Ref `src/logic.frag:45-101`.

    `flows`: list of flow grids `f32[4, H, W]` (LOD pyramid);
    `targets`: `f32[4, N]` (xy read); `view_size`: `f32[2]` cover-aspect
    scale; `flow_force_fn(pos_screen [N, 2]) -> f32[2, N]` overrides the
    flow-force evaluation (carried force, kernel gather)."""
    pos = particles[:2]
    vel = particles[2:]

    alive = (pos[0] != INERT) | (pos[1] != INERT)

    wander = wander_force(pos, uv, index01, params, time)

    # Flow force from LAST frame's flow (ref `src/index.js:296-298`).
    pos_screen = torch.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                             dim=-1)
    if flow_force_fn is not None:
        flow_force = flow_force_fn(pos_screen)
    else:
        flow_force = flow_ops.flow_at_screen_pos(
            pos_screen, flows, time, params["flowDecay"], sample_fn)

    force_w = vary(params["forceWeight"], index01, params["varyForce"])
    flow_w = vary(params["flowWeight"], index01, params["varyFlow"])
    noise_w = vary(params["noiseWeight"], index01, params["varyNoise"])

    new_vel = (vel * params["damping"] * dt
               + force_w * (flow_force * dt * flow_w
                            + wander * dt * noise_w))

    # Tend towards targets — ref `src/logic.frag:85`.
    target_w = vary(params["target"], index01, params["varyTarget"])
    new_vel = new_vel + (targets[:2] - pos) * target_w

    # Speed clamp — ref `src/logic.frag:92-94` (zero velocity stays zero).
    speed = torch.sqrt(new_vel[0] ** 2 + new_vel[1] ** 2)
    scale = (torch.minimum(speed, params["speedLimit"])
             / torch.clamp(speed, min=1e-12))
    new_vel = new_vel * scale

    new_pos = pos + new_vel

    new_pos = torch.where(alive, new_pos, pos)
    new_vel = torch.where(alive, new_vel, vel)
    return torch.cat([new_pos, new_vel])
