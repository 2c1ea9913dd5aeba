"""The Tendrils engine — orchestration of step / draw / spawn.

The port of `tendrils_tpu/engine.py` for its resident-stream frames with
the carried flow force and the fused draw (`EngineConfig` defaults with
`flow_levels=1`, `flow_res=None`, a 1x1 colour map, `flowWeight != 0` and
line widths <= `KMAX_WIDTH`). Per frame:

    step_sim   logic step (plain tensor code); the flow force comes carried
               from the previous frame, or is gathered in the step (K5);
    draw_sim   pack (K1), sort, splat (K2), resolve (K3) and the next
               force's gather with the state reassembly (K4); the sorted
               order becomes the next frame's row order (`sim.idx`).

The interactive frame (`Tendrils.step_draw_io`, `_frame_io`) edits the flow
after the draw — pointer flow lines (`_inject_flow`, the point splat K9)
and the camera's optical flow (`ops.optical_flow`) — so its draw only
reassembles the state (K6), and the next force is gathered afterwards from
the final flow (`force_from_aux`, K8).

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
import torch.nn.functional as F

from . import state as state_mod
from .const import INERT
from .ops import coords, flow as flow_ops, logic, not_ported
from .ops import optical_flow as of_ops, spawn as spawn_ops
from .ops import splat as splat_ops
from .ops.draw_cuda import (KMAX_WIDTH, fused_draw, pos_scale_for,
                            reconstruct_resident)
from .ops.gather_cuda import (bilinear_gather, bilinear_gather_keyed_p1,
                              gather_reconstruct_p1)
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


def force_from_aux(flow, aux, params, read_time, cfg: EngineConfig,
                   unsort=True):
    """The next step's flow force: `flow` decayed to `read_time`, gathered
    at the draw's sorted p1 stream (`aux = (idx_s, p1_s)`) by K8. In the
    resident stream (`unsort=False`) the sorted order IS the new row order,
    so the exact f32 force is returned as is."""
    if unsort:
        raise not_ported("the non-resident carried force (the q15 keyed "
                         "gather K7 and its un-sort)", 7)
    return bilinear_gather_keyed_p1(
        _decayed(flow, read_time, params), aux[1],
        inv_p=1.0 / pos_scale_for(cfg.flow_shape))


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
    sort and the returned sim is permuted into the sorted row order
    (`sim.idx` tracks identity). `previous` is reconstructed as pos - vel
    for live rows, its velocity half as the current velocity (the
    reference package's documented deviation).

    With `want_force` the next step's force is gathered in the same pass
    that rebuilds the state (K4), from the flow K3 decays to `read_time`,
    and set on `sim.force`; without it the state is rebuilt alone (K6) and
    the caller gathers the force once it has edited the flow
    (`force_from_aux`). Returns `(sim', aux)`, aux = (sorted ids, sorted p1
    words).

    The arguments are those of the JAX function; the port requires
    `resident`, `want_aux`, `stepped` and `fast_resolve`, with
    `targets_live=False`. K3 emits the decayed flow exactly when K4 reads
    it, so `want_eff` is accepted only with `want_force`: the port does
    not return `eff`."""
    if axis_name is not None:
        raise not_ported("the sharded draw", 12)
    if not (cfg.fused_draw and cfg.splat_backend == "kernel"
            and cfg.flow_shape == cfg.view_res):
        raise not_ported("the generic (xla) draw", 4)
    if not (resident and want_aux and stepped):
        raise not_ported("non-resident draws (the classic carried force, "
                         "the paused draw)", 7)
    if cfg.merge_reorder:
        raise not_ported("the merge reorder", 10)
    if targets_live:
        raise not_ported("live targets riding the sort", 7)
    if flow_off:
        raise not_ported("flow_off (flowWeight == 0)", 7)
    if not fast_resolve:
        raise not_ported("the XLA resolve tail (line widths above "
                         "KMAX_WIDTH)", 7)
    if cfg.color_map_res != (1, 1):
        raise not_ported("textured colour maps", 7)
    if want_eff and not want_force:
        raise not_ported("returning the decayed flow (want_eff without "
                         "want_force)", 7)
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
    new_flow, view0, aux, ride_s, *eff = fused_draw(
        sim.flow, sim.view[0], None, p1, vel, pos, None,
        alive.to(torch.float32), params, time, grid_hw=(h, w),
        samples=cfg.view_samples, idx=sim.idx,
        ride=[sim.particles[0], sim.particles[1]], idx_bound=cfg.n,
        derive_p0=True, view_size=view_size, mapped_scalar=mapped_scalar,
        resolve="kernel", read_time=read_time, want_eff=want_force)
    sl = torch.clamp(params["speedLimit"], min=1e-12)
    force = None
    if want_force:
        force, particles, previous = gather_reconstruct_p1(
            eff[0], aux[1], ride_s[0], ride_s[1], ride_s[2], sl,
            inv_p=1.0 / pos_scale_for((h, w)))
    else:
        particles, previous = reconstruct_resident(ride_s[0], ride_s[1],
                                                   ride_s[2], sl)
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


def _inject_flow(flow, p0_pix, p1_pix, vel, width, params, time, cfg,
                 samples=None):
    """Flow-line segment injection (ref `demo.main.js:1107-1122`): the
    segments' velocity payload splatted over the flow grid (K9). Shared by
    the facade method and the io frame."""
    if cfg.splat_backend != "kernel":
        raise not_ported("the xla splat backend (the generic splat)", 4)
    payload = flow_ops.flow_payload(vel, time, params["speedLimit"])
    return splat_ops.splat_segments(
        flow, p0_pix, p1_pix, payload, payload[3], grid_hw=cfg.flow_shape,
        width=width, samples=samples or cfg.flow_samples,
        rows=max(1, cfg.flow_rows))


def _resize_payload(payload, hw):
    """`f32[4, h, w]` -> `f32[4, *hw]` as `jax.image.resize(..., "bilinear")`
    does: plain bilinear (align_corners=False, edges clamped) where no axis
    shrinks, the antialiased triangle filter where one does (torch's
    `antialias=True`, which widens the filter only along the shrinking
    axis). Both agree with JAX to ~2e-7 on values in [-1, 1]
    (tests/test_torch_optical_flow.py)."""
    if tuple(payload.shape[1:]) == tuple(hw):
        return payload
    shrinks = payload.shape[1] > hw[0] or payload.shape[2] > hw[1]
    return F.interpolate(payload[None], size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=shrinks)[0]


def _frame_io(sim, params, time, dt, cfg, view_size, cm, cm_alphas, seg, of,
              blur, bokeh=None, stepping=True, targets_live=True,
              fast_resolve=False, flow_off=False):
    """The interactive frame (the JAX `_frame_io_jit`): step + resident
    draw, then [pointer flow lines] and [optical-flow composite], then the
    next force gathered from the FINAL flow at `time + dt` (the reference's
    logic pass sees the flow lines and optical flow written this frame,
    `demo.main.js:1107-1160`). Without either input the draw gathers the
    force itself (K4), exactly as the JAX function fuses it.

    `seg`: `(p0_pix, p1_pix, vel, width)` tensors; `of`: `(current, last,
    offset, lambda, speed)`, frames as device tensors, the uniforms host
    numbers. Returns `(sim', None)` (the screen of the post stack is not
    ported)."""
    del cm_alphas
    if cm is not None:
        raise not_ported("textured colour maps (the io frame's colour-map "
                         "blend)", 7)
    if blur is not None or bokeh is not None:
        raise not_ported("the post stack (blur, bokeh)", 9)
    if not stepping:
        raise not_ported("the paused io frame", 7)
    if not resident_enabled(cfg):
        raise not_ported("non-resident frames (the classic carried force "
                         "and the generic draw)", 7)
    edits = seg is not None or of is not None
    sim = step_sim(sim, params, time, dt, cfg, view_size, flow_off=flow_off)
    sim, aux = draw_sim(sim, params, time, cfg, view_size, want_aux=True,
                        resident=True, targets_live=targets_live,
                        stepped=True, fast_resolve=fast_resolve,
                        read_time=time + dt, want_force=not edits,
                        flow_off=flow_off)
    if seg is not None:
        p0, p1, vel, width = seg
        sim = dataclasses.replace(
            sim, flow=_inject_flow(sim.flow, p0, p1, vel, width, params,
                                   time, cfg))
    if of is not None:
        cur, last, offset, lam, speed = of
        payload = of_ops.optical_flow(cur, last, time, offset=offset,
                                      lambda_=lam, speed=speed,
                                      speed_limit=params["speedLimit"])
        payload = _resize_payload(payload, cfg.flow_shape)
        sim = dataclasses.replace(
            sim, flow=of_ops.composite_flow(sim.flow, payload))
    if edits:
        sim = dataclasses.replace(sim, force=force_from_aux(
            sim.flow, aux, params, time + dt, cfg, unsort=False))
    return sim, None


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

    # -- flow injection (flow lines, optical flow)

    def _segment_tensors(self, p0_pix, p1_pix, vel):
        """Segments as f32 tensors on the engine's device. The JAX facade
        pads their count to a power-of-two bucket (`_bucket_segments`) to
        spare XLA a recompile; PyTorch compiles nothing per shape, so the
        port does not pad. Pad segments have zero velocity, hence zero
        payload weight and alpha, and deposit nothing: the result is the
        same (tests/test_torch_frame_io.py)."""
        return tuple(torch.as_tensor(a, dtype=torch.float32,
                                     device=self.device)
                     for a in (p0_pix, p1_pix, vel))

    def inject_flow_segments(self, p0_pix, p1_pix, vel, width_px,
                             samples=None):
        """Splat velocity-painting segments into the flow grid (the
        FlowLine ribbons of `demo.main.js:1107-1122`). `p0_pix`, `p1_pix`:
        `[S, 2]` window px; `vel`: `[2, S]` in the flow-payload
        convention. Drops the carried force, which predates the edit (the
        next frame gathers in the step, K5)."""
        if len(p0_pix) == 0:
            return self
        new_flow = _inject_flow(
            self.sim.flow, *self._segment_tensors(p0_pix, p1_pix, vel),
            _f32(max(width_px, 1.0), self.device), self.params(),
            _f32(self.timer.time, self.device), self.config,
            samples=samples)
        self.sim = dataclasses.replace(self.sim, flow=new_flow, force=None)
        return self

    def step_draw_io(self, *, color_maps=None, color_alphas=None,
                     segments=None, of_frames=None, of_uniforms=None,
                     blur=None, bokeh=None):
        """The interactive frame (no timer tick, like `step_draw`): step +
        draw, pointer flow-line injection, optical-flow composite, then the
        next force from the final flow — the reference's per-frame stack
        (`demo.main.js:1024-1161`).

        `segments`: `(p0_pix, p1_pix, vel, width_px)` pointer ribbons
        (`flow_line.FlowLines.segments`); `of_frames`: `(current, last)`
        frames (`media.OpticalFlow.device_buffers`, u8 or f32) with
        `of_uniforms` (offset / lambda / speed, host numbers). Colour maps,
        the blur and bokeh post stack and the paused frame are not ported
        yet (they raise). Returns None (no post stage)."""
        self._check_force_params()
        seg = None
        if segments is not None and len(segments[0]):
            seg = (*self._segment_tensors(*segments[:3]),
                   _f32(max(segments[3], 1.0), self.device))
        of = None
        if of_frames is not None:
            u = dict({"offset": 1.0, "lambda": 0.001, "speed": 1.0},
                     **(of_uniforms or {}))
            # u8 camera frames stay u8 across any upload here.
            of = (torch.as_tensor(of_frames[0], device=self.device),
                  torch.as_tensor(of_frames[1], device=self.device),
                  float(u["offset"]), float(u["lambda"]), float(u["speed"]))
        self.sim, screen = _frame_io(
            self.sim, self.params(), _f32(self.timer.time, self.device),
            _f32(self.timer.dt, self.device), self.config, self._view_size,
            color_maps, color_alphas, seg, of, blur, bokeh,
            stepping=not self.timer.paused,
            targets_live=self._targets_live,
            fast_resolve=fast_resolve_ok(self.config, self.state),
            flow_off=flow_force_unused(self.state))
        return screen

    def composite_flow(self, payload_grid):
        """Alpha-blend a full-screen flow payload (e.g. optical flow) over
        the flow grid — ref `demo.main.js:1150-1156` — resized to the flow
        grid first. Drops the carried force, as `inject_flow_segments`."""
        payload = _resize_payload(
            torch.as_tensor(payload_grid, dtype=torch.float32,
                            device=self.device), self.config.flow_shape)
        self.sim = dataclasses.replace(
            self.sim, flow=of_ops.composite_flow(self.sim.flow, payload),
            force=None)
        return self

    @property
    def view_image(self):
        """Current view buffer as `f32[H, W, 4]`, row 0 at top (display)."""
        return self.sim.view[0].permute(1, 2, 0).flip(0)
