"""Parameter schema and simulation state.

Mirrors `tendrils_tpu/state.py`: the reference's `defaults()` state schema
(`src/index.js:28-75`) with identical field names and values, and the same
struct-of-arrays layout — particles `f32[4, N]` with rows (pos.x, pos.y,
vel.x, vel.y), grids `f32[4, H, W]`, view buffers `f32[B, 4, H, W]`, row
identities `i32[N]`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .const import INERT


def default_state() -> dict[str, Any]:
    """Engine parameter schema — ref `src/index.js:29-66`, same values."""
    return {
        "rootNum": 2 ** 9,

        "autoClearView": False,
        "autoFade": True,

        "damping": 0.043,
        "speedLimit": 0.01,

        "forceWeight": 0.016,
        "varyForce": -0.1,

        "flowWeight": 1.0,
        "varyFlow": 0.2,

        "noiseWeight": 0.002,
        "varyNoise": 0.3,

        "flowDecay": 0.005,
        "flowWidth": 5.0,

        "noiseScale": 2.125,
        "varyNoiseScale": 0.5,

        "noiseSpeed": 0.00025,
        "varyNoiseSpeed": 0.1,

        "target": 0.0,
        "varyTarget": 1.0,

        "lineWidth": 1.0,
        "speedAlpha": 0.000001,
        "colorMapAlpha": 0.4,

        "baseColor": [1.0, 1.0, 1.0, 0.5],
        "flowColor": [1.0, 1.0, 1.0, 0.04],
        "fadeColor": [0.1333, 0.1333, 0.1333, 0.0],
    }


# Structural parameters (shapes / control flow): engine config, not
# per-frame tensors.
_STATIC_KEYS = ("rootNum", "autoClearView", "autoFade")


def params_from_state(state: dict[str, Any], device="cpu") -> dict[str, Any]:
    """Every non-structural field of a state dict as an f32 tensor on
    `device` (scalars 0-d, colours `f32[4]`)."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in state.items() if k not in _STATIC_KEYS}


@dataclasses.dataclass
class SimState:
    """The mutable sim state, one dataclass of tensors.

    particles / previous: `f32[4, N]` current and previous particle state
        (the reference's ping-pong pair, `src/particles.js:81-92`);
    targets: `f32[4, N]` seek targets — `src/index.js:105`;
    flow: `f32[4, H, W]` flow field — `src/index.js:102`;
    view: `f32[B, 4, H, W]` view/trail buffers — `src/index.js:109`;
    color_map: `f32[4, ch, cw]` colour map — `src/index.js:94-96`;
    idx: `i32[N]` original particle index per row. Resident-stream frames
        reorder the rows by the draw's segment sort, so per-particle
        constants are recomputed from `idx`;
    force: `f32[2, N]` or None — the flow force for the NEXT step, gathered
        at the end of the previous frame; None = gather in the step.

    The JAX state's threefry `key` has no counterpart: the ball spawn is a
    deterministic coordinate hash, and stochastic spawns will take an
    explicit `torch.Generator`.
    """
    particles: torch.Tensor
    previous: torch.Tensor
    targets: torch.Tensor
    flow: torch.Tensor
    view: torch.Tensor
    color_map: torch.Tensor
    idx: torch.Tensor
    force: Any = None


def make_state(root_num: int = 512, view_res=(720, 1280), num_view_buffers=1,
               color_map_res=(1, 1), flow_res=None, *,
               device="cpu") -> SimState:
    """Allocate a fresh SimState on `device`: all particles inert (ref
    `src/spawn/init/cpu.js:1-8`), grids zero. `view_res` is (H, W);
    `flow_res` defaults to `view_res` (ref `src/index.js:405`)."""
    n = int(root_num) * int(root_num)
    h, w = view_res
    fh, fw = (flow_res if flow_res is not None else view_res)
    ch, cw = color_map_res
    f32 = dict(dtype=torch.float32, device=device)
    particles = torch.cat([torch.full((2, n), float(INERT), **f32),
                           torch.zeros((2, n), **f32)])
    return SimState(
        particles=particles,
        previous=particles.clone(),
        targets=torch.zeros((4, n), **f32),
        flow=torch.zeros((4, fh, fw), **f32),
        view=torch.zeros((num_view_buffers, 4, h, w), **f32),
        color_map=torch.zeros((4, ch, cw), **f32),
        idx=torch.arange(n, dtype=torch.int32, device=device),
    )


def particle_coords_from_idx(idx, root_num):
    """Per-particle constants from original indices.

    Returns (uv `f32[2, N]`, index01 `f32[N]`, colormap_uv `f32[2, N]`),
    the same arithmetic as the JAX function."""
    r = root_num
    idx = idx.to(torch.float32)
    ix = torch.fmod(idx, r)  # idx >= 0: fmod == jnp.mod, and exact
    iy = torch.floor(idx / r)
    uv = torch.stack([(ix + 0.5) / r, (iy + 0.5) / r])
    index01 = ((ix + 0.5) + (iy + 0.5) * r) / (r * r)
    cm_x = ix / max(r - 1, 1)
    cm_y = torch.clamp(iy * 2.0 / max(2 * r - 1, 1) * 2.0, max=1.0)
    colormap_uv = torch.stack([cm_x, cm_y])
    return uv, index01, colormap_uv
