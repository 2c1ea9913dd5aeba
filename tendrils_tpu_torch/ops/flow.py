"""Flow-field payload, decay-on-read and multi-level sampling.

Mirrors `tendrils_tpu/ops/flow.py`. Payload (one flow texel, `f32[4]`) —
`src/flow/apply/state.glsl:5-17`: (vel.x, vel.y, stamp=time,
weight=min(|vel| / speedLimit, 1)). Decay-on-read — `src/flow/get.glsl:3-5`:
vel_effective = vel * max(0, 1 - (time - stamp) * decay).
"""

import torch

from . import coords, sample


def flow_payload(vel, time, speed_limit):
    """`vel: f32[2, N]` -> payload `f32[4, N]` of (vx, vy, stamp, weight).
    `time` and `speed_limit` may be numbers or 0-d tensors."""
    speed = torch.sqrt(vel[0] * vel[0] + vel[1] * vel[1])
    weight = torch.clamp(speed / speed_limit, max=1.0)
    stamp = torch.zeros_like(weight) + time
    return torch.stack([vel[0], vel[1], stamp, weight])


def flow_decayed(data, time, decay):
    """`data: f32[4, ...]` -> effective velocity `f32[2, ...]`."""
    age = torch.clamp(1.0 - (time - data[2]) * decay, min=0.0)
    return data[:2] * age


def flow_at_screen_pos(pos_screen, flows, time, flow_decay, sample_fn=None):
    """Flow force at clip-space positions `pos_screen: f32[N, 2]` (already
    `pos * viewSize`) from one flow grid per LOD level — ref
    `src/flow/flow-at-screen-pos.glsl`. Returns `f32[2, N]`."""
    if sample_fn is None:
        sample_fn = sample.sample_uv
    uv = coords.pos_to_uv(pos_screen)
    force = 0.0
    total = 0.0
    for level, grid in enumerate(flows):
        data = sample_fn(grid, uv)
        factor = 1.0 / (level + 1.0)
        force = force + flow_decayed(data, time, flow_decay) * factor
        total = total + factor
    return force / total
