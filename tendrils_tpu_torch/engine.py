"""The Tendrils engine — orchestration of step / draw / spawn.

The port of `tendrils_tpu/engine.py` for its hot frame: the resident-stream
frame with the carried flow force and the fused draw (`EngineConfig`
defaults with `flow_levels=1`, `flow_res=None`, a 1x1 colour map,
`flowWeight != 0` and line widths <= `KMAX_WIDTH`). Per frame:

    step_sim   logic step (plain tensor code); the flow force comes carried
               from the previous frame, or is gathered in the step (K5);
    draw_sim   pack (K1), sort, splat (K2), resolve (K3) and the next
               force's gather with the state reassembly (K4); the sorted
               order becomes the next frame's row order (`sim.idx`).

The ordering invariant of the reference holds: the step reads the flow
BEFORE this frame's deposit (`src/index.js:297-298`). Every other frame
variant raises NotImplementedError naming its ROADMAP.md item; nothing
silently takes another path. PyTorch runs eagerly, so there is no jit and
no scan: `run_headless` is a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import state as state_mod
from .const import INERT
from .ops import coords, logic, not_ported, spawn as spawn_ops
from .ops.draw_cuda import KMAX_WIDTH, fused_draw, pos_scale_for
from .ops.gather_cuda import bilinear_gather, gather_reconstruct_p1
from .timer import Timer


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (shape-affecting) engine configuration."""
    root_num: int = 512
    view_res: tuple[int, int] = (720, 1280)  # (H, W)
    flow_res: tuple[int, int] | None = None  # defaults to view_res
    num_view_buffers: int = 1
    color_map_res: tuple[int, int] = (1, 1)
    flow_levels: int = 1  # ref compiles levels=1 (src/logic.frag:39)
    flow_samples: int = 4
    flow_rows: int = 3
    view_samples: int = 4
    view_rows: int = 1
    # "kernel": the hand-written CUDA kernels (their plain versions on CPU
    # tensors) — the JAX package's "pallas".
    splat_backend: str = "kernel"
    gather_backend: str = "kernel"
    fused_draw: bool = True
    carry_force: bool = True
    resident_stream: bool = True
    merge_reorder: bool = False

    @property
    def n(self) -> int:
        return self.root_num * self.root_num

    @property
    def flow_shape(self) -> tuple[int, int]:
        return self.flow_res if self.flow_res is not None else self.view_res


def carry_enabled(cfg: EngineConfig) -> bool:
    """Whether the carried-force fast path is active."""
    return (cfg.carry_force and cfg.fused_draw
            and cfg.splat_backend == "kernel"
            and cfg.gather_backend == "kernel"
            and cfg.flow_levels == 1
            and cfg.flow_shape == cfg.view_res)


def resident_enabled(cfg: EngineConfig) -> bool:
    """Whether the frame runs in resident-stream mode (the state rides the
    draw's segment sort)."""
    return carry_enabled(cfg) and cfg.resident_stream


def fast_resolve_ok(cfg: EngineConfig, src=None) -> bool:
    """Whether the fused resolve (K3) applies: the fused kernel draw and
    host-known line widths within the in-kernel budget. `src`: the
    engine's state dict or a params dict (reading a device tensor here
    synchronises once). The CUDA resolve takes any grid shape, so the TPU
    alignment test has no counterpart."""
    if not (cfg.fused_draw and cfg.splat_backend == "kernel"
            and cfg.flow_shape == cfg.view_res) or src is None:
        return False
    fw = float(src.get("flowWidth", 1.0))
    lw = float(src.get("lineWidth", 1.0))
    return max(fw, lw, 1.0) <= KMAX_WIDTH


def flow_force_unused(src) -> bool:
    """Host-known `flowWeight == 0`: the flow-force term is exactly zero."""
    if src is None:
        return False
    return float(src.get("flowWeight", 1.0)) == 0.0


def _decayed(flow, time, params):
    """The flow's velocity decayed to `time` (`src/flow/get.glsl:3-5`),
    `f32[2, H, W]`."""
    return flow[:2] * torch.clamp(
        1.0 - (time - flow[2]) * params["flowDecay"], min=0.0)[None]


def initial_force(sim: state_mod.SimState, params, cfg: EngineConfig,
                  view_size, read_time):
    """Flow-force gather at the current positions (K5), to seed the carried
    force before a headless run."""
    h, w = cfg.flow_shape
    pos = sim.particles[:2]
    eff = _decayed(sim.flow, read_time, params)
    u0 = (pos[0] * view_size[0]) * 0.5 + 0.5
    u1 = (pos[1] * view_size[1]) * 0.5 + 0.5
    return bilinear_gather(eff, u0 * w, u1 * h)


def step_sim(sim: state_mod.SimState, params, time, dt, cfg: EngineConfig,
             view_size, flow_off=False):
    """Logic step + ping-pong — ref `src/index.js:248-272`.

    Uses the carried force when the previous frame left one, else decays
    the flow grid once and gathers its 2 velocity channels (K5) at the
    particles' screen positions."""
    if flow_off:
        raise not_ported("flow_off (flowWeight == 0)", 7)
    if cfg.gather_backend != "kernel" or cfg.flow_levels != 1:
        raise not_ported("the xla gather backend and flow pyramids", 7)
    uv, index01, _ = state_mod.particle_coords_from_idx(sim.idx,
                                                        cfg.root_num)
    if sim.force is not None:
        # Carried force: gathered at the end of the previous frame from its
        # final flow at these exact positions. Consumed once.
        force = sim.force

        def flow_force_fn(pos_screen):
            del pos_screen
            return force
    else:
        eff = _decayed(sim.flow, time, params)
        _, h, w = eff.shape

        def flow_force_fn(pos_screen):
            u = pos_screen * 0.5 + 0.5
            return bilinear_gather(eff, u[:, 0] * w, u[:, 1] * h)

    new_particles = logic.step_particles(
        sim.particles, None, sim.targets, params, uv, index01, view_size,
        time, dt, flow_force_fn=flow_force_fn)
    return dataclasses.replace(sim, particles=new_particles,
                               previous=sim.particles, force=None)


def draw_sim(sim: state_mod.SimState, params, time, cfg: EngineConfig,
             view_size, axis_name=None, want_aux=False, resident=False,
             targets_live=True, stepped=False, fast_resolve=False,
             read_time=None, want_eff=False, want_force=False,
             flow_off=False):
    """Flow + view render passes — ref `src/index.js:278-340` — in the
    resident-stream variant: the exact positions ride the draw's segment
    sort, the returned sim is permuted into the sorted row order (`sim.idx`
    tracks identity), and the next step's force is gathered in the same
    pass that rebuilds the state (K4) and set on `sim.force`. `previous` is
    reconstructed as pos - vel for live rows, its velocity half as the
    current velocity (the reference package's documented deviation).
    Returns `(sim', aux)`, aux = (sorted ids, sorted p1 words).

    The arguments are those of the JAX function; the port requires
    `resident`, `want_aux`, `stepped`, `fast_resolve`, `want_eff` and
    `want_force`, with `targets_live=False`."""
    if axis_name is not None:
        raise not_ported("the sharded draw", 12)
    if not (cfg.fused_draw and cfg.splat_backend == "kernel"
            and cfg.flow_shape == cfg.view_res):
        raise not_ported("the generic (xla) draw", 4)
    if not (resident and want_aux and stepped and want_force):
        raise not_ported("non-resident draws (the classic carried force, "
                         "the paused draw)", 7)
    if cfg.merge_reorder:
        raise not_ported("the merge reorder", 10)
    if targets_live:
        raise not_ported("live targets riding the sort", 7)
    if flow_off:
        raise not_ported("flow_off (flowWeight == 0)", 7)
    if not (fast_resolve and want_eff):
        raise not_ported("the XLA resolve tail (line widths above "
                         "KMAX_WIDTH)", 7)
    if cfg.color_map_res != (1, 1):
        raise not_ported("textured colour maps", 7)
    pos = sim.particles[:2]
    vel = sim.particles[2:]
    prev_pos = sim.previous[:2]
    alive = ((pos[0] != INERT) | (pos[1] != INERT)) & \
            ((prev_pos[0] != INERT) | (prev_pos[1] != INERT))
    h, w = cfg.view_res
    # 1x1 colour map: the whole render colour model runs in the splat.
    mapped_scalar = sim.color_map[:, 0, 0] * params["colorMapAlpha"]
    p1 = coords.clip_to_pixel(
        torch.stack([pos[0] * view_size[0], pos[1] * view_size[1]], dim=-1),
        (w, h))
    # p0 is derived in the splat from p1 and the velocity (derive_p0).
    new_flow, view0, aux, ride_s, eff = fused_draw(
        sim.flow, sim.view[0], None, p1, vel, pos, None,
        alive.to(torch.float32), params, time, grid_hw=(h, w),
        samples=cfg.view_samples, idx=sim.idx,
        ride=[sim.particles[0], sim.particles[1]], idx_bound=cfg.n,
        derive_p0=True, view_size=view_size, mapped_scalar=mapped_scalar,
        resolve="kernel", read_time=read_time, want_eff=True)
    force, particles, previous = gather_reconstruct_p1(
        eff, aux[1], ride_s[0], ride_s[1], ride_s[2],
        torch.clamp(params["speedLimit"], min=1e-12),
        inv_p=1.0 / pos_scale_for((h, w)))
    new_sim = dataclasses.replace(
        sim, particles=particles, previous=previous, idx=aux[0],
        flow=new_flow, view=torch.cat([view0[None], sim.view[1:]]),
        force=force)
    return new_sim, aux


def _frame(sim, params, time, dt, cfg, view_size, targets_live=True,
           fast_resolve=False, flow_off=False):
    """One resident frame: step + draw, the next force carried on `sim`."""
    if not resident_enabled(cfg):
        raise not_ported("non-resident frames (the classic carried force "
                         "and the generic draw)", 7)
    sim = step_sim(sim, params, time, dt, cfg, view_size, flow_off=flow_off)
    sim, _ = draw_sim(sim, params, time, cfg, view_size, want_aux=True,
                      resident=True, targets_live=targets_live,
                      stepped=True, fast_resolve=fast_resolve,
                      read_time=time + dt, want_eff=fast_resolve,
                      want_force=True, flow_off=flow_off)
    return sim


def _f32(v, device):
    """A 0-d f32 tensor on `device` (a device fill for host numbers)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def run_headless(sim, params, cfg: EngineConfig, view_size, t0, dt, steps,
                 targets_live=True, fast_resolve=None, flow_off=False):
    """Fixed-step headless run of `steps` frames at times t0 + dt*(i + 1).
    The carried force is seeded once by a gather at the start (K5).
    Returns the final state."""
    if flow_off or not carry_enabled(cfg):
        raise not_ported("headless runs without the carried force", 7)
    device = sim.particles.device
    t0, dt = _f32(t0, device), _f32(dt, device)
    if sim.force is None:
        sim = dataclasses.replace(
            sim, force=initial_force(sim, params, cfg, view_size, t0 + dt))
    if fast_resolve is None:
        fast_resolve = fast_resolve_ok(cfg, params)
    for i in range(steps):
        sim = _frame(sim, params, t0 + dt * float(i + 1), dt, cfg,
                     view_size, targets_live=targets_live,
                     fast_resolve=fast_resolve)
    return sim


# --- Stateful engine --------------------------------------------------------


class Tendrils:
    """Stateful engine facade mirroring the reference class API
    (`src/index.js:83`): setup / reset / restart / step / frame / spawn /
    spawn_shader / clear*, on `device` ("cuda" by default; the tests pass
    "cpu", where every kernel takes its plain version)."""

    def __init__(self, config: EngineConfig | None = None, *,
                 timer: Timer | None = None, device="cuda", **overrides):
        self.config = config or EngineConfig(**overrides)
        self.device = torch.device(device)
        # Live-tweakable parameter dict (host-side mirror of
        # `defaults().state`); converted to device tensors per call.
        self.state = state_mod.default_state()
        self.timer = timer or Timer()
        if timer is None:
            self.timer.step = 1000.0 / 60.0  # ref src/index.js:67
        self.sim: state_mod.SimState | None = None
        self._pcache: dict[str, Any] = {}  # params() device tensor cache
        self._setup_static()

    def _setup_static(self):
        h, w = self.config.view_res
        self._view_size = torch.as_tensor(coords.cover_aspect((w, h)),
                                          device=self.device)
        # Whether the targets buffer may hold live data (a target spawn ran
        # since setup).
        self._targets_live = False

    # Per-particle constants derive from the (resident-sorted) row
    # permutation `sim.idx`.
    @property
    def _uv(self):
        return state_mod.particle_coords_from_idx(
            self.sim.idx, self.config.root_num)[0]

    @property
    def _frag_xy(self):
        return self._uv * self.config.root_num  # texel-centre frag coords

    def _check_force_params(self):
        """Drop the carried force if the params it baked in (flowDecay,
        speedLimit) changed host-side since it was gathered."""
        key = (float(self.state.get("flowDecay", 0.0)),
               float(self.state.get("speedLimit", 0.0)))
        if self.sim is not None and self.sim.force is not None \
                and key != getattr(self, "_force_key", key):
            self.sim = dataclasses.replace(self.sim, force=None)
        self._force_key = key

    def setup(self, root_num: int | None = None):
        """(Re)allocate particle + grid state — ref `src/index.js:149-154`."""
        if root_num is not None and root_num != self.config.root_num:
            self.config = dataclasses.replace(self.config,
                                              root_num=int(root_num))
            self.state["rootNum"] = int(root_num)
            self._setup_static()
        cfg = self.config
        self.sim = state_mod.make_state(
            cfg.root_num, cfg.view_res, cfg.num_view_buffers,
            cfg.color_map_res, cfg.flow_shape, device=self.device)
        self.reset()
        return self

    def reset(self):
        """Respawn all-inert — ref `src/index.js:156-160`."""
        return self.spawn()

    def restart(self):
        """Clear + reset — ref `src/index.js:241-246`."""
        self.clear()
        return self.reset()

    # -- clears (ref src/index.js:215-239)

    def clear(self):
        return self.clear_view().clear_flow()

    def clear_view(self):
        self.sim = dataclasses.replace(self.sim,
                                       view=torch.zeros_like(self.sim.view))
        return self

    def clear_flow(self):
        self.sim = dataclasses.replace(self.sim,
                                       flow=torch.zeros_like(self.sim.flow),
                                       force=None)
        return self

    # -- parameters

    def params(self):
        """Device-tensor view of `state`, converted per key only when the
        host value changed (each conversion is a host-to-device copy)."""
        cache = self._pcache
        out = {}
        for k, v in self.state.items():
            if k in state_mod._STATIC_KEYS:
                continue
            hv = torch.as_tensor(v, dtype=torch.float32)
            hk = (tuple(hv.shape), tuple(hv.reshape(-1).tolist()))
            ent = cache.get(k)
            if ent is None or ent[0] != hk:
                ent = (hk, hv.to(self.device))
                cache[k] = ent
            out[k] = ent[1]
        for k, on in (("autoClearView", self.state.get("autoClearView")),
                      ("autoFade", self.state.get("autoFade", True))):
            val = 1.0 if on else 0.0
            ent = cache.get(k)
            if ent is None or ent[0] != val:
                ent = (val, _f32(val, self.device))
                cache[k] = ent
            out[k] = ent[1]
        return out

    # -- per-frame API

    def step(self):
        """Ref `src/index.js:248-272` (honours timer pause)."""
        self._check_force_params()
        if not self.timer.paused:
            self.sim = step_sim(self.sim, self.params(),
                                _f32(self.timer.time, self.device),
                                _f32(self.timer.dt, self.device),
                                self.config, self._view_size,
                                flow_off=flow_force_unused(self.state))
        return self

    def draw(self):
        """Ref `src/index.js:278-340`: a draw with no step before it."""
        raise not_ported("the paused draw()", 7)

    def step_draw(self):
        """step + draw with no timer tick — for hosts that tick timers
        themselves."""
        self._check_force_params()
        if self.timer.paused:
            return self.draw()
        self.sim = _frame(self.sim, self.params(),
                          _f32(self.timer.time, self.device),
                          _f32(self.timer.dt, self.device), self.config,
                          self._view_size, targets_live=self._targets_live,
                          fast_resolve=fast_resolve_ok(self.config,
                                                       self.state),
                          flow_off=flow_force_unused(self.state))
        return self

    def frame(self):
        """tick + step + draw — the hot loop."""
        self.timer.tick()
        return self.step_draw()

    # -- spawning

    def spawn(self, spawner=None):
        """Replace both ping-pong buffers — ref `src/index.js:425-429`.
        `spawner`: `f32[4, N] -> f32[4, N]` (default: all-inert init)."""
        fn = spawner or spawn_ops.init
        particles = fn(self.sim.particles)
        self.sim = dataclasses.replace(self.sim, particles=particles,
                                       previous=particles, force=None)
        return self

    def spawn_shader(self, op, target=None):
        """GPU-respawn equivalent — ref `src/index.js:432-457`.
        `op(prev_particles, engine) -> f32[4, N]`; rotates the ping-pong
        and replaces the current state."""
        self.timer.tick()
        if target == "targets":
            raise not_ported("target spawns (live targets)", 7)
        if target is not None:
            raise ValueError(f"unknown spawn target: {target}")
        new = op(self.sim.particles, self)
        self.sim = dataclasses.replace(self.sim, particles=new,
                                       previous=self.sim.particles,
                                       force=None)
        return self

    @property
    def view_image(self):
        """Current view buffer as `f32[H, W, 4]`, row 0 at top (display)."""
        return self.sim.view[0].permute(1, 2, 0).flip(0)
