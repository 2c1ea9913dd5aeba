"""The Tendrils engine — orchestration of step / draw / spawn.

The port of `tendrils_tpu/engine.py`. Per frame:

    step_sim   logic step (K13, one pass over the particles); the flow
               force comes carried from the previous frame, or is
               gathered before the step: K5 on
               the flow decayed once, one call per pyramid level, with
               `gather_backend="kernel"`; the reference's interpolate-then-
               decay order in plain tensor code with "xla";
    draw_sim   the fused draw: pack (K1), sort, splat (K2), and the
               resolve: K3, or the XLA tail (line widths above KMAX_WIDTH,
               the paused draw); or the generic draw: the flow pass and
               the view pass, each its segments' samples splatted (K9 with
               `splat_backend="kernel"`, an f32 scatter with "xla") and
               composited over its grid.

The fused draw runs where `fused_draw` is set, the splat backend is
"kernel" and the flow grid is the view's (`flow_res` None or equal); the
generic draw runs everywhere else, as in the JAX package: with
`fused_draw=False`, on the "xla" splat backend (the JAX package's
default) and with a flow grid of its own. The carried force needs the
fused draw, the "kernel" gather and one flow level (`carry_enabled`);
without it every step gathers its own force.

The resident frame (`resident_stream=True`, the default) lets the state
ride the draw's sort: the next force's gather and the state reassembly
run in one pass (K4), and the sorted order becomes the next frame's row
order (`sim.idx`); once a target spawn has run, the targets ride with
the positions (K4 and K6 re-stack them). With `merge_reorder=True` it
restores that order by merging the rows whose key changed (K10, K11;
`ops/reorder_cuda.py`) against the carry `sim.sort_key` /
`sim.sort_hist`, instead of sorting all N rows. The classic frame
(`resident_stream=False`) and the paused draw (`Tendrils.draw`) keep the
row order: the draw sends the exact p0 and rgba8 colour streams, and the
next force is gathered at the sorted p1 (K7, packed q15) and un-sorted by
row id (`force_from_aux`). A textured colour map sends the rgba8 stream
on the resident frame too.

One function assembles a frame, `_frame`: the headless frame
(`Tendrils.frame`, `run_headless`, `parallel.sharding`) and the
interactive one (`Tendrils.step_draw_io`) are the same call, the
second with inputs. It blends the colour maps before the step and
edits the flow after the draw — pointer flow lines (`_inject_flow`, the
point splat on the config's splat backend) and the camera's optical
flow (`ops.optical_flow`) — so a frame with edits only reassembles the
state in its draw (K6), and the next force is gathered afterwards from
the final flow (`force_from_aux`, K8 or K7). `_frame_io` is that frame
followed by the post stage (`ops/post.py`: the vignette blur, then the
bokeh), which returns the screen. The facade reads a frame's inputs
once (`Tendrils._frame_inputs`).

With `flowWeight == 0` (`flow_force_unused`, BASELINE config 1) the flow
term of the step is exactly zero: the step gathers nothing, no frame
carries a force, and the kernel draw prunes the flow channels (K2 and K3
view-only) and passes the flow grid through untouched, as the JAX package
does; a draw whose flow is edited keeps all 11 channels.

The ordering invariant of the reference holds: the step reads the flow
BEFORE this frame's deposit (`src/index.js:297-298`). A frame whose
particles are split over ranks (`parallel/`) draws with `axis_name`, a
process group: each rank splats its own rows and the splat sums are
summed over the ranks before the resolve, so every rank holds the whole
frame's grids. PyTorch runs eagerly, so there is no jit and no scan:
`run_headless` is a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from . import state as state_mod
from .const import INERT
from .ops import coords, flow as flow_ops, logic_cuda
from .ops import optical_flow as of_ops, post as post_ops, render, sample
from .ops import spawn as spawn_ops, splat as splat_ops
from .ops.draw_cuda import (KMAX_WIDTH, device_f32, fused_draw, gather_mode,
                            pos_scale_for, reconstruct_resident,
                            seg_tile_count)
from .ops.gather_cuda import (bilinear_gather, bilinear_gather_keyed_p1,
                              bilinear_gather_keyed_q15,
                              gather_reconstruct_p1)
from .ops.reorder_cuda import MAXKEY, merge_eligible
from .ops.tile_geom import HALF
from .timer import Timer
from .utils.profiling import span


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
    # tensors) — the JAX package's "pallas"; "xla": plain tensor code, the
    # JAX package's portable backends (its defaults), which run the generic
    # draw and the reference's gather order.
    splat_backend: str = "kernel"
    gather_backend: str = "kernel"
    fused_draw: bool = True
    carry_force: bool = True
    resident_stream: bool = True
    # Merge reorder: restore the resident stream's sorted row order by
    # merging the churned rows instead of sorting all N (falls back to the
    # sort whenever its guards trip). Off by default, as in the JAX package.
    merge_reorder: bool = False

    @property
    def n(self) -> int:
        return self.root_num * self.root_num

    @property
    def flow_shape(self) -> tuple[int, int]:
        return self.flow_res if self.flow_res is not None else self.view_res


def flow_pyramid(flow_grid, levels):
    """LOD pyramid for multi-level flow sampling (ref
    `flow-at-screen-pos.glsl` levels loop; the reference ships one level):
    each level the mean of the previous one's 2 x 2 texel blocks. A level
    that cannot halve raises, as the JAX function's `reshape` does."""
    grids = [flow_grid]
    g = flow_grid
    for _ in range(1, levels):
        c, h, w = g.shape
        if h % 2 or w % 2:
            raise ValueError(f"flow pyramid: a {h}x{w} level cannot halve "
                             f"({levels} levels of {tuple(flow_grid.shape)})")
        g = g.reshape(c, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        grids.append(g)
    return grids


def fused_draw_ok(cfg: EngineConfig) -> bool:
    """Whether `draw_sim` takes the fused draw (`fused_draw`, the "kernel"
    splat, one grid shape); else it takes the generic draw."""
    return (cfg.fused_draw and cfg.splat_backend == "kernel"
            and cfg.flow_shape == cfg.view_res)


def carry_enabled(cfg: EngineConfig) -> bool:
    """Whether the carried-force fast path is active."""
    return (cfg.carry_force and fused_draw_ok(cfg)
            and cfg.gather_backend == "kernel" and cfg.flow_levels == 1)


def resident_enabled(cfg: EngineConfig) -> bool:
    """Whether the frame runs in resident-stream mode (the state rides the
    draw's segment sort)."""
    return carry_enabled(cfg) and cfg.resident_stream


def merge_reorder_enabled(cfg: EngineConfig) -> bool:
    """Whether resident frames restore sortedness by the merge reorder:
    the flag, the resident frame, and the resident draw's stream admitted
    by `reorder_cuda.merge_eligible`, the gate the draw applies too."""
    return (cfg.merge_reorder and resident_enabled(cfg)
            and merge_eligible(cfg.n, gather_mode(
                cfg.n, seg_tile_count(cfg.view_res), ids=True,
                resident=True, idx_bound=cfg.n)))


def seed_sort_carry(sim: state_mod.SimState,
                    cfg: EngineConfig) -> state_mod.SimState:
    """(Re)seed the merge-reorder carry: an all-MAXKEY previous key makes
    every row count as churned on the next frame, so the merge's capacity
    guard trips into the flat sort, which re-establishes a valid carry."""
    dev = sim.particles.device
    return dataclasses.replace(
        sim, sort_key=torch.full((cfg.n,), MAXKEY, dtype=torch.int32,
                                 device=dev),
        sort_hist=torch.zeros(seg_tile_count(cfg.view_res),
                              dtype=torch.int32, device=dev))


def host_widths(src) -> tuple[float, float]:
    """`(flowWidth, lineWidth)` as host numbers, from the engine's state
    dict or a params dict (reading a device tensor synchronises once)."""
    return float(src.get("flowWidth", 1.0)), float(src.get("lineWidth", 1.0))


def fast_resolve_ok(cfg: EngineConfig, widths) -> bool:
    """Whether the fused resolve (K3) applies: the fused kernel draw and
    host-known line widths, the `(flowWidth, lineWidth)` pair of
    `host_widths`, within the in-kernel budget. The CUDA resolve takes
    any grid shape, so the TPU alignment test has no counterpart."""
    return fused_draw_ok(cfg) and max(*widths, 1.0) <= KMAX_WIDTH


def flow_force_unused(src) -> bool:
    """Host-known `flowWeight == 0`: the flow-force term is exactly zero."""
    if src is None:
        return False
    return float(src.get("flowWeight", 1.0)) == 0.0


def with_view0(views, view0):
    """The view ring `views` `f32[B, 4, H, W]` with `view0` as its head
    buffer: `view0[None]`, a view and no copy, with one buffer (the
    default); else `view0` before the other buffers. No path writes into
    a view tensor in place (K3, `composite_over` and `fade_fill` return
    fresh ones), so an older `SimState` may share it."""
    if views.shape[0] == 1:
        return view0[None]
    return torch.cat([view0[None], views[1:]])


def _decayed(flow, time, params):
    """The flow's velocity decayed to `time` (`src/flow/get.glsl:3-5`),
    `f32[2, H, W]`."""
    return flow[:2] * torch.clamp(
        1.0 - (time - flow[2]) * params["flowDecay"], min=0.0)[None]


def force_from_aux(flow, aux, params, read_time, cfg: EngineConfig,
                   unsort=True, eff=None):
    """The next step's flow force, gathered at the draw's sorted p1 stream
    (`aux = (idx_s, p1_s)`) from `eff`, or from `flow` decayed to
    `read_time` when `eff` is None (`eff` is K3's decayed flow, valid only
    when nothing edited the flow since the draw).

    With `unsort=False` (the resident stream) the sorted order IS the new
    row order: the exact f32 force is returned as K8 gathers it. With
    `unsort=True` (classic frames, the paused draw) K7 packs the force as
    two q15 fields over +-speedLimit, the words are scattered back to row
    order by the unique row ids (`out[idx_s] = packed`; the JAX package
    un-sorts with `lax.sort`, outside any kernel) and decoded."""
    with span("draw"):
        inv_p = 1.0 / pos_scale_for(cfg.flow_shape)
        if eff is None:
            eff = _decayed(flow, read_time, params)
        if not unsort:
            return bilinear_gather_keyed_p1(eff, aux[1], inv_p=inv_p)
        sl = torch.clamp(params["speedLimit"], min=1e-12)
        packed = bilinear_gather_keyed_q15(eff.contiguous(), aux[1],
                                           1.0 / sl, inv_p=inv_p)
        pk = torch.empty_like(packed)
        pk[aux[0].to(torch.int64)] = packed

        def unq(q):
            return (q.to(torch.float32) * (2.0 / HALF) - 1.0) * sl

        return torch.stack([unq(pk & HALF), unq(pk >> 15)])


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


def _step_force(sim, params, time, cfg: EngineConfig, view_size):
    """The flow force `f32[2, N]` gathered for the step at the particles'
    screen positions (no carried force): K5 on the flow decayed once, on
    each level of its pyramid weighted 1/(level + 1), on the "kernel"
    gather backend; `flow.flow_at_screen_pos` on the raw pyramid on "xla"."""
    pos = sim.particles[:2]
    pos_screen = torch.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                             dim=-1)
    if cfg.gather_backend == "xla":
        return flow_ops.flow_at_screen_pos(
            pos_screen, flow_pyramid(sim.flow, cfg.flow_levels), time,
            params["flowDecay"])
    # Decay-then-interpolate matches the reference's interpolate-then-decay
    # but where stale and live texels mix (both ~0 there).
    eff_pyr = flow_pyramid(_decayed(sim.flow, time, params), cfg.flow_levels)
    u = pos_screen * 0.5 + 0.5
    force = total = 0.0
    for level, grid in enumerate(eff_pyr):
        _, h, w = grid.shape
        factor = 1.0 / (level + 1.0)
        force = force + bilinear_gather(grid, u[:, 0] * w, u[:, 1] * h) \
            * factor
        total = total + factor
    return force / total


def step_sim(sim: state_mod.SimState, params, time, dt, cfg: EngineConfig,
             view_size, flow_off=False):
    """Logic step + ping-pong — ref `src/index.js:248-272`: K13
    (`logic_cuda.logic_step`; its plain version on CPU tensors).

    Uses the carried force when the previous frame left one, else gathers
    one (`_step_force`). `flow_off` (host-known `flowWeight == 0`,
    `flow_force_unused`): the flow term is exactly zero, the parameter
    variance being multiplicative (ref `src/logic.frag:41-43`), so nothing
    is decayed or gathered."""
    with span("logic"):
        if cfg.gather_backend not in ("xla", "kernel"):
            raise ValueError(f"unknown gather backend: {cfg.gather_backend}")
        if flow_off:
            force = None
        elif sim.force is not None:
            # Carried force: gathered at the end of the previous frame from its
            # final flow at these exact positions. Consumed once.
            force = sim.force
        else:
            force = _step_force(sim, params, time, cfg, view_size)
        new_particles = logic_cuda.logic_step(
            sim.particles, sim.targets, sim.idx, force, params, time, dt,
            cfg.root_num)
        return dataclasses.replace(sim, particles=new_particles,
                                   previous=sim.particles, force=None)


def draw_sim(sim: state_mod.SimState, params, time, cfg: EngineConfig,
             view_size, axis_name=None, want_aux=False, resident=False,
             targets_live=True, fast_resolve=False, read_time=None,
             want_eff=False, want_force=False, flow_off=False,
             host_widths=None):
    """Flow + view render passes — ref `src/index.js:278-340`: the fused
    draw where it applies (`fused_draw`, the "kernel" splat, one grid
    shape), else the generic draw (`_draw_generic`), which takes none of
    the options below but `axis_name` and returns `sim'` alone.

    `axis_name` (the JAX function's shard_map axis): the process group, or
    a callable that sums a tensor over the ranks, of a frame whose
    particles are split over ranks; `sim` holds this rank's rows and the
    whole grids. The fused draw sums K2's int64 sums over the ranks
    before their conversion (`draw_cuda.fused_draw(psum=...)`), so the
    accumulator is that of one device drawing every row, bit for bit; the
    generic draw sums its f32 parts, once a frame, as the JAX function
    psums them. Every rank then resolves the same grids.

    `resident` (with `want_aux`; a step just preceded the draw): the exact
    positions ride the draw's segment sort and the returned sim is
    permuted into the sorted row order (`sim.idx` tracks identity).
    `previous` is reconstructed as pos - vel for live rows, its velocity
    half as the current velocity (the reference package's documented
    deviation, read only by the best-sample target-spawn scorers). With
    `targets_live` (a target spawn ran) the targets' xy rows ride the sort
    too and come back re-stacked as `(tx, ty, 0, 0)`; without it the
    targets pass through untouched. With `want_force` the next step's
    force is gathered in the same pass that rebuilds the state (K4), from
    the flow decayed to `read_time`, and set on `sim.force`; without it
    the state is rebuilt alone (K6) and the caller gathers the force once
    it has edited the flow (`force_from_aux`).

    Otherwise the draw keeps the row order, and so never moves the
    targets, and sends the exact p0 stream;
    with `want_aux` it carries the row ids (gather mode 1) for the force
    gather. A 1x1 colour map on the resident frame is four scalars for
    the splat; every other draw samples the map per particle
    (`colormap_uv` from `sim.idx`) and packs the colours to rgba8.

    `fast_resolve` (line widths <= KMAX_WIDTH): K3 resolves, with
    `autoClearView` and the fade; with `want_eff` (and `want_aux`) it also
    emits the flow decayed to `read_time`. Without it the view is cleared
    and faded here and the XLA tail resolves; `host_widths` (port only:
    the host's `(flowWidth, lineWidth)`) decides its blur without reading
    the device. `flow_off` prunes the flow channels where `fused_draw`
    admits it (K3, no decayed flow wanted): the flow grid passes through.

    A resident draw of a sim that carries `sort_key` restores the row order
    by the merge reorder and returns the new carry on the sim; where the
    draw does not admit the merge, the carry is re-seeded
    (`seed_sort_carry`).

    Returns `(sim', aux[, eff])` with `want_aux` (aux = (sorted row ids,
    sorted p1 words); `eff` with `want_eff` when no force was gathered),
    else `sim'`, as the JAX function does."""
    with span("draw"):
        if not fused_draw_ok(cfg):
            if want_aux or want_force:
                raise ValueError("want_aux and want_force need the fused draw "
                                 "(carry_enabled)")
            return _draw_generic(sim, params, time, cfg, view_size,
                                 psum=axis_name)
        resident = resident and want_aux
        if want_force and not resident:
            raise ValueError("want_force requires the resident draw "
                             "(resident=True with want_aux)")
        pos = sim.particles[:2]
        vel = sim.particles[2:]
        prev_pos = sim.previous[:2]
        alive = ((pos[0] != INERT) | (pos[1] != INERT)) & \
                ((prev_pos[0] != INERT) | (prev_pos[1] != INERT))
        h, w = cfg.view_res
        mapped = mapped_scalar = None
        if resident and cfg.color_map_res == (1, 1):
            # The whole render colour model runs in the splat.
            mapped_scalar = sim.color_map[:, 0, 0] * params["colorMapAlpha"]
        else:
            colormap_uv = state_mod.particle_coords_from_idx(
                sim.idx, cfg.root_num)[2]
            mapped = sample.sample_uv(sim.color_map, colormap_uv.T) \
                * params["colorMapAlpha"]
        p1 = coords.clip_to_pixel(
            torch.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                        dim=-1), (w, h))
        p0 = None
        if not resident:
            p0 = coords.clip_to_pixel(
                torch.stack([prev_pos[0] * view_size[0],
                             prev_pos[1] * view_size[1]], dim=-1), (w, h))
        view0 = sim.view[0]
        if not fast_resolve:
            # K3 clears and fades in-kernel; the XLA tail's caller does it.
            view0 = render.fade_fill(view0 * (1.0 - params["autoClearView"]),
                                     params["fadeColor"] * params["autoFade"])
        idx = ride = None
        targets_live = resident and targets_live
        if resident:
            # The exact positions ride the sort; live targets ride beside them,
            # inert ones do not (the buffer passes through untouched).
            idx, ride = sim.idx, [sim.particles[0], sim.particles[1]]
            if targets_live:
                ride += [sim.targets[0], sim.targets[1]]
        elif want_aux:
            # The aux id is the ROW number: the force un-sorts to row order.
            idx = torch.arange(pos.shape[1], dtype=torch.int32,
                               device=pos.device)
        reorder = None
        if resident and sim.sort_key is not None:
            # The merge-reorder carry: the keys the current row order is sorted
            # by and their tile census.
            reorder = (sim.sort_key, sim.sort_hist)
        want_eff = want_eff and fast_resolve and want_aux
        # K3 emits the decayed flow whenever it is read: by the caller
        # (`want_eff`) or by K4 here.
        k3_eff = fast_resolve and (want_eff or want_force)
        new_flow, view0, aux, ride_s, *rest = fused_draw(
            sim.flow, view0, p0, p1, vel, pos, mapped,
            alive.to(torch.float32), params, time, grid_hw=(h, w),
            samples=cfg.view_samples, idx=idx, ride=ride,
            idx_bound=cfg.n if resident else None, derive_p0=resident,
            view_size=view_size if resident else None,
            mapped_scalar=mapped_scalar,
            resolve="kernel" if fast_resolve else "xla", read_time=read_time,
            want_eff=k3_eff, flow_off=flow_off, reorder=reorder,
            host_widths=host_widths, psum=axis_name, adds_rows=cfg.n)
        carry = rest.pop() if reorder is not None else None
        eff = rest[0] if rest else None
        view = with_view0(sim.view, view0)
        if not resident:
            new_sim = dataclasses.replace(sim, flow=new_flow, view=view)
            if not want_aux:
                return new_sim
            return (new_sim, aux, eff) if want_eff else (new_sim, aux)
        sl = torch.clamp(params["speedLimit"], min=1e-12)
        # ride_s = [x, y, (tx, ty,) vl]: the sorted velocity words last.
        targ = ride_s[2:4] if targets_live else ()
        force = None
        if want_force:
            if read_time is None:
                raise ValueError("want_force needs read_time")
            if eff is None:
                eff = _decayed(new_flow, read_time, params)
            force, *rec = gather_reconstruct_p1(
                eff.contiguous(), aux[1], ride_s[0], ride_s[1], ride_s[-1], sl,
                *targ, inv_p=1.0 / pos_scale_for((h, w)))
        else:
            rec = reconstruct_resident(ride_s[0], ride_s[1], ride_s[-1], sl,
                                       *targ)
        new_sim = dataclasses.replace(
            sim, particles=rec[0], previous=rec[1],
            targets=rec[2] if targets_live else sim.targets, idx=aux[0],
            flow=new_flow, view=view, force=force)
        if reorder is not None:
            if carry is None:
                # The draw did not admit the merge: the next frame falls back.
                carry = (torch.full_like(sim.sort_key, MAXKEY),
                         torch.zeros_like(sim.sort_hist))
            new_sim = dataclasses.replace(new_sim, sort_key=carry[0],
                                          sort_hist=carry[1])
        if want_eff and not want_force:
            return new_sim, aux, eff
        return new_sim, aux


def _draw_generic(sim, params, time, cfg, view_size, psum=None):
    """The generic draw — ref `src/index.js:278-340`, JAX `draw_sim`'s
    two-pass branch: the flow pass splats each particle's segment
    (previous -> current position, in `flow_shape` pixels) with its
    velocity payload (`flow.flow_payload`) at `flowWidth`, `flow_samples`
    x `flow_rows` samples, and composites it over the flow grid, which is
    not cleared (it decays on read); the view pass clears
    (`autoClearView`) and fades the view, then splats the particles'
    render colours (`render.particle_colors`) at `lineWidth`,
    `view_samples` x `view_rows`, and composites them over it. Each splat
    runs on `cfg.splat_backend` (K9, or the f32 scatter). `psum` (a
    shard's, see `draw_sim`): both passes' parts are summed over the
    ranks in one collective before they are composited. K9's fixed-point
    steps come from its samples (its first launch), so the ranks' int64
    sums are not at one step: the f32 parts are summed, as the JAX
    function psums them, and agree with one device's within f32 rounding."""
    pos = sim.particles[:2]
    vel = sim.particles[2:]
    prev_pos = sim.previous[:2]
    colormap_uv = state_mod.particle_coords_from_idx(sim.idx,
                                                     cfg.root_num)[2]
    live = (((pos[0] != INERT) | (pos[1] != INERT))
            & ((prev_pos[0] != INERT) | (prev_pos[1] != INERT))).to(
                torch.float32)
    # Segment endpoints in window pixels of each target grid.
    p_clip0 = torch.stack([prev_pos[0] * view_size[0],
                           prev_pos[1] * view_size[1]], dim=-1)
    p_clip1 = torch.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                          dim=-1)
    fh, fw = cfg.flow_shape
    payload = flow_ops.flow_payload(vel, time, params["speedLimit"])
    flow_parts = splat_ops.splat_segments_accumulate(
        coords.clip_to_pixel(p_clip0, (fw, fh)),
        coords.clip_to_pixel(p_clip1, (fw, fh)), payload,
        payload[3] * live, grid_hw=(fh, fw), width=params["flowWidth"],
        samples=cfg.flow_samples, rows=cfg.flow_rows,
        backend=cfg.splat_backend)
    h, w = cfg.view_res
    colors = render.particle_colors(pos, vel, colormap_uv, sim.color_map,
                                    params, time)
    view_parts = splat_ops.splat_segments_accumulate(
        coords.clip_to_pixel(p_clip0, (w, h)),
        coords.clip_to_pixel(p_clip1, (w, h)), colors, colors[3] * live,
        grid_hw=(h, w), width=params["lineWidth"],
        samples=cfg.view_samples, rows=cfg.view_rows,
        backend=cfg.splat_backend)
    if psum is not None:
        from .parallel.comm import reduce_parts
        flow_parts, view_parts = reduce_parts(psum, flow_parts, view_parts)
    new_flow = splat_ops.composite_over(sim.flow, *flow_parts)
    view0 = render.fade_fill(sim.view[0] * (1.0 - params["autoClearView"]),
                             params["fadeColor"] * params["autoFade"])
    view0 = splat_ops.composite_over(view0, *view_parts)
    return dataclasses.replace(sim, flow=new_flow,
                               view=with_view0(sim.view, view0))


def _draw(sim, params, time, dt, cfg, view_size, flow_off=False,
          host_widths=None):
    """The paused draw (the JAX `_draw_jit`): a draw with no step before
    it, so the exact p0 stream and rgba8 colours, the XLA resolve tail,
    and the next force gathered from the flow decayed to `time + dt` (K7,
    un-sorted to row order). With `flowWeight == 0` or without the carried
    force it is a plain draw and drops any force."""
    if flow_off or not carry_enabled(cfg):
        if sim.force is not None:
            sim = dataclasses.replace(sim, force=None)
        return draw_sim(sim, params, time, cfg, view_size,
                        host_widths=host_widths)
    sim, aux = draw_sim(sim, params, time, cfg, view_size, want_aux=True,
                        host_widths=host_widths)
    return dataclasses.replace(sim, force=force_from_aux(
        sim.flow, aux, params, time + dt, cfg))


def _inject_flow(flow, p0_pix, p1_pix, vel, width, params, time, cfg,
                 samples=None):
    """Flow-line segment injection (ref `demo.main.js:1107-1122`): the
    segments' velocity payload splatted over the flow grid on the config's
    splat backend (K9, or the f32 scatter). Shared by the facade method and
    the io frame."""
    payload = flow_ops.flow_payload(vel, time, params["speedLimit"])
    return splat_ops.splat_segments(
        flow, p0_pix, p1_pix, payload, payload[3], grid_hw=cfg.flow_shape,
        width=width, samples=samples or cfg.flow_samples,
        rows=max(1, cfg.flow_rows), backend=cfg.splat_backend)


def _resize_payload(grid, hw):
    """`f32[C, h, w]` -> `f32[C, *hw]` as `jax.image.resize(..., "bilinear")`
    does: plain bilinear (align_corners=False, edges clamped) where no axis
    shrinks, the antialiased triangle filter where one does (torch's
    `antialias=True`, which widens the filter only along the shrinking
    axis). Both agree with JAX to ~2e-7 on values in [-1, 1]
    (tests/test_torch_optical_flow.py, tests/test_torch_frame_io.py)."""
    if tuple(grid.shape[1:]) == tuple(hw):
        return grid
    shrinks = grid.shape[1] > hw[0] or grid.shape[2] > hw[1]
    return F.interpolate(grid[None], size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=shrinks)[0]


def _frame(sim, params, time, dt, cfg, view_size, *, cm=None, cm_alphas=None,
           seg=None, of=None, stepping=True, targets_live=True,
           fast_resolve=False, flow_off=False, host_widths=None,
           axis_name=None):
    """One frame, the one orchestration of every entry (the JAX
    `_frame_jit` and `_frame_io_jit`): [colour-map blend], step + draw,
    then [pointer flow lines] and [optical-flow composite], then the next
    force, carried on `sim'`, from the FINAL flow at `time + dt` (the
    reference's logic pass sees the flow lines and optical flow written
    this frame, `demo.main.js:1107-1160`): K8 on the resident stream, K7
    and the un-sort on the classic one. Without either input the resident
    draw gathers the force itself (K4), and a classic draw hands K3's
    decayed flow to K7, as the JAX functions fuse them. Without the
    carried force the step gathers its own (K5) and the draw gathers
    none. `stepping=False` (the paused timer) skips only the step: a
    plain draw (gather mode 0, the XLA tail) and every input still land,
    and no force is carried.

    A force the frame will not use (no carried force, the paused timer,
    `flow_off`) is dropped on entry. On every state the engine reaches
    the headless frame's result is unchanged by it: `run_headless` strips
    such a force, `draw()` and the spawns set or clear it, and a
    `flow_off` step discards it.

    `flow_off` (`flowWeight == 0`): no force is gathered; the resident
    draw rebuilds the state alone (K6), the classic one is a plain draw
    (no ids, no K7); the draw prunes the flow channels only when neither
    input edits the flow.

    `cm`: colour-map tensors `f32[4, h, w]`, resized to the largest and
    blended with `cm_alphas` (`post.blend`, ref `demo.main.js:1070-1079`);
    `seg`: `(p0_pix, p1_pix, vel, width)` tensors; `of`: `(current, last,
    offset, lambda, speed)`, frames as device tensors, the uniforms host
    numbers. `axis_name`: the draw's (a shard's frame,
    `parallel.sharding.parallel_frame`); the step and the force gathers
    run on this rank's rows, the gathers from the whole flow every rank
    holds. Returns `sim'`."""
    carry = carry_enabled(cfg) and stepping and not flow_off
    if not carry and sim.force is not None:
        sim = dataclasses.replace(sim, force=None)
    if cm is not None:
        target = max((g.shape for g in cm), key=lambda sh: sh[1] * sh[2])
        sim = dataclasses.replace(sim, color_map=post_ops.blend(
            [_resize_payload(g, target[1:]) for g in cm], cm_alphas))
    resident = resident_enabled(cfg) and stepping
    edits = seg is not None or of is not None
    want_force = resident and not edits and not flow_off
    aux = eff = None
    if not stepping:
        sim = draw_sim(sim, params, time, cfg, view_size,
                       host_widths=host_widths, axis_name=axis_name)
    else:
        sim = step_sim(sim, params, time, dt, cfg, view_size,
                       flow_off=flow_off)
        if carry or (resident and flow_off):
            # (resident + flow_off: no force, but the state still rides
            # the draw's sort, so the rows stay tile-ordered.)
            sim, aux, *eff = draw_sim(
                sim, params, time, cfg, view_size, want_aux=True,
                resident=resident, targets_live=targets_live,
                fast_resolve=fast_resolve, read_time=time + dt,
                want_eff=fast_resolve and not edits and not flow_off,
                want_force=want_force, flow_off=flow_off and not edits,
                host_widths=host_widths, axis_name=axis_name)
            eff = eff[0] if eff else None
            if want_force or flow_off:
                aux = None  # the draw set sim.force (K4), or none is read
        else:
            sim = draw_sim(sim, params, time, cfg, view_size,
                           fast_resolve=fast_resolve,
                           flow_off=flow_off and not edits,
                           host_widths=host_widths, axis_name=axis_name)
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
    if aux is not None:
        sim = dataclasses.replace(sim, force=force_from_aux(
            sim.flow, aux, params, time + dt, cfg, unsort=not resident,
            eff=eff))
    return sim


def _frame_io(sim, params, time, dt, cfg, view_size, *, blur=None,
              bokeh=None, **frame):
    """`_frame` (its keywords in `frame`), then the post stage on the new
    view: `blur` `(radius, limit)` the vignette blur and `bokeh`
    `(radius, amount)` the bokeh, after the blur when both are set (the
    blur stack's windowed boxes). Returns `(sim', screen)`, the screen
    None without a post stage."""
    sim = _frame(sim, params, time, dt, cfg, view_size, **frame)
    if blur is None and bokeh is None:
        return sim, None
    with span("post"):
        screen = sim.view[0]
        if blur is not None:
            screen = post_ops.vignette_blur(screen, *blur)
        if bokeh is not None:
            screen = post_ops.bokeh(screen, *bokeh)
    return sim, screen


def run_headless(sim, params, cfg: EngineConfig, view_size, t0, dt, steps,
                 targets_live=True, fast_resolve=None, flow_off=False):
    """Fixed-step headless run of `steps` frames at times t0 + dt*(i + 1)
    (`_frame`). With the carried force it is seeded once by a gather at the
    start (K5); without it each step gathers its own; with `flow_off`
    (`flowWeight == 0`) nothing is gathered. The merge-reorder carry is
    seeded when the merge is enabled and stripped when it is not. Returns
    the final state."""
    device = sim.particles.device
    t0, dt = device_f32(t0, device), device_f32(dt, device)
    carry = carry_enabled(cfg) and not flow_off
    if carry and sim.force is None:
        sim = dataclasses.replace(
            sim, force=initial_force(sim, params, cfg, view_size, t0 + dt))
    elif not carry and sim.force is not None:
        sim = dataclasses.replace(sim, force=None)
    merge = merge_reorder_enabled(cfg)
    if merge and sim.sort_key is None:
        sim = seed_sort_carry(sim, cfg)
    elif not merge and sim.sort_key is not None:
        sim = dataclasses.replace(sim, sort_key=None, sort_hist=None)
    widths = host_widths(params)
    if fast_resolve is None:
        fast_resolve = fast_resolve_ok(cfg, widths)
    for i in range(steps):
        sim = _frame(sim, params, t0 + dt * float(i + 1), dt, cfg,
                     view_size, targets_live=targets_live,
                     fast_resolve=fast_resolve, flow_off=flow_off,
                     host_widths=widths)
    return sim


class FrameInputs(NamedTuple):
    """A frame's inputs, read once (`Tendrils._frame_inputs`): the
    parameters as device tensors, `time` and `dt` as device scalars, and
    the host-known switches of `_frame`."""
    params: dict
    time: torch.Tensor
    dt: torch.Tensor
    flow_off: bool
    fast_resolve: bool
    host_widths: tuple[float, float]
    targets_live: bool

    def switches(self):
        """`_frame`'s keywords from the host state."""
        return dict(targets_live=self.targets_live,
                    fast_resolve=self.fast_resolve, flow_off=self.flow_off,
                    host_widths=self.host_widths)


# --- Stateful engine --------------------------------------------------------


class Tendrils:
    """Stateful engine facade mirroring the reference class API
    (`src/index.js:83`): setup / reset / restart / step / frame / spawn /
    spawn_shader / clear*, on `device` ("cuda" by default; the tests pass
    "cpu", where every kernel takes its plain version). `seed` is the JAX
    facade's: kept as `self.seed`, it seeds `self.generator`, the
    `torch.Generator` that stochastic spawners draw from."""

    def __init__(self, config: EngineConfig | None = None, *,
                 timer: Timer | None = None, seed: int = 0, device="cuda",
                 **overrides):
        self.config = config or EngineConfig(**overrides)
        self.device = torch.device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
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
            cfg.color_map_res, self.seed, cfg.flow_shape,
            device=self.device)
        self.reseed_derived()
        self.reset()
        return self

    def reset(self):
        """Respawn all-inert — ref `src/index.js:156-160`."""
        return self.spawn()

    def reseed_derived(self):
        """Re-seed the state's derived caches after a state swap (setup, a
        converted state): the merge-reorder carry gets its MAXKEY seed when
        the merge is enabled (the next frame flat-sorts and re-establishes
        it) and is dropped when it is not; the carried force stays."""
        if self.sim is not None:
            if merge_reorder_enabled(self.config):
                self.sim = seed_sort_carry(self.sim, self.config)
            elif self.sim.sort_key is not None:
                self.sim = dataclasses.replace(self.sim, sort_key=None,
                                               sort_hist=None)
        return self

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
        with span("params"):
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
            for k, on in (("autoClearView",
                           self.state.get("autoClearView")),
                          ("autoFade", self.state.get("autoFade", True))):
                val = 1.0 if on else 0.0
                ent = cache.get(k)
                if ent is None or ent[0] != val:
                    ent = (val, device_f32(val, self.device))
                    cache[k] = ent
                out[k] = ent[1]
            return out

    # -- per-frame API

    def _frame_inputs(self) -> FrameInputs:
        """A frame's inputs, read once by every frame entry (here and in
        `parallel/`): the device parameters (`params()`), the timer's
        `time` and `dt` as device fills, and from the host state
        `flow_force_unused`, `fast_resolve_ok`, `host_widths` and whether
        the targets are live. The entries that step first drop a carried
        force whose params changed (`_check_force_params`), paused or
        not; `draw()` does not, as the JAX facade's, and a paused entry
        reads no inputs for the step it skips."""
        widths = host_widths(self.state)
        return FrameInputs(
            self.params(), device_f32(self.timer.time, self.device),
            device_f32(self.timer.dt, self.device),
            flow_force_unused(self.state),
            fast_resolve_ok(self.config, widths), widths,
            self._targets_live)

    def step(self):
        """Ref `src/index.js:248-272` (honours timer pause)."""
        with span("frame"):
            self._check_force_params()
            if not self.timer.paused:
                x = self._frame_inputs()
                self.sim = step_sim(self.sim, x.params, x.time, x.dt,
                                    self.config, self._view_size,
                                    flow_off=x.flow_off)
        return self

    def draw(self):
        """Ref `src/index.js:278-340`: a draw with no step before it
        (`_draw`), the next force gathered after it."""
        with span("frame"):
            x = self._frame_inputs()
            self.sim = _draw(self.sim, x.params, x.time, x.dt, self.config,
                             self._view_size, flow_off=x.flow_off,
                             host_widths=x.host_widths)
        return self

    def step_draw(self):
        """step + draw with no timer tick — for hosts that tick timers
        themselves."""
        self._check_force_params()
        if self.timer.paused:
            return self.draw()
        with span("frame"):
            x = self._frame_inputs()
            self.sim = _frame(self.sim, x.params, x.time, x.dt, self.config,
                              self._view_size, **x.switches())
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

        `op(prev_particles, engine) -> f32[4, N]`. With no `target`,
        rotates the ping-pong and replaces the current state (reading the
        pre-spawn current, `src/particles.js:128-143`) and drops the
        carried force; with `target="targets"` writes the targets buffer
        without rotating (reading `previous`) and marks the targets live,
        so that from now on they ride the resident draw's sort."""
        self.timer.tick()
        if target is None:
            new = op(self.sim.particles, self)
            self.sim = dataclasses.replace(self.sim, particles=new,
                                           previous=self.sim.particles,
                                           force=None)
        elif target == "targets":
            new = op(self.sim.previous, self)
            self.sim = dataclasses.replace(self.sim, targets=new)
            self._targets_live = True
        else:
            raise ValueError(f"unknown spawn target: {target}")
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
            device_f32(max(width_px, 1.0), self.device), self.params(),
            device_f32(self.timer.time, self.device), self.config,
            samples=samples)
        self.sim = dataclasses.replace(self.sim, flow=new_flow, force=None)
        return self

    def step_draw_io(self, *, color_maps=None, color_alphas=None,
                     segments=None, of_frames=None, of_uniforms=None,
                     blur=None, bokeh=None):
        """The interactive frame (no timer tick, like `step_draw`):
        colour-map blend, step + draw, pointer flow-line injection,
        optical-flow composite, then the next force from the final flow —
        the reference's per-frame stack (`demo.main.js:1024-1161`).

        `color_maps`: `f32[4, h, w]` grids (numpy or tensors) blended into
        the colour map with `color_alphas` weights (ref
        `demo.main.js:1070-1079`); the config's `color_map_res` follows the
        largest. `segments`: `(p0_pix, p1_pix, vel, width_px)` pointer
        ribbons (`flow_line.FlowLines.segments`); `of_frames`: `(current,
        last)` frames (`media.OpticalFlow.device_buffers`, u8 or f32) with
        `of_uniforms` (offset / lambda / speed, host numbers); `blur`:
        `(radius, limit)`, the demo's vignette blur; `bokeh`: `(radius,
        amount)`, the bokeh screen pass (`src/screen/bokeh.frag`), after
        the blur when both are set. While the timer is paused only the
        step is skipped. Returns the post-processed screen `f32[4, H, W]`,
        or None without a post stage."""
        with span("frame"):
            self._check_force_params()
            x = self._frame_inputs()
            cm = None
            if color_maps is not None:
                cm = tuple(torch.as_tensor(g, dtype=torch.float32,
                                           device=self.device)
                           for g in color_maps)
                target = max((g.shape for g in cm),
                             key=lambda sh: sh[1] * sh[2])
                if tuple(target) != tuple(self.sim.color_map.shape):
                    self.config = dataclasses.replace(
                        self.config, color_map_res=tuple(target[1:]))
                color_alphas = torch.as_tensor(color_alphas,
                                               dtype=torch.float32,
                                               device=self.device)
            seg = None
            if segments is not None and len(segments[0]):
                seg = (*self._segment_tensors(*segments[:3]),
                       device_f32(max(segments[3], 1.0), self.device))
            of = None
            if of_frames is not None:
                u = dict({"offset": 1.0, "lambda": 0.001, "speed": 1.0},
                         **(of_uniforms or {}))
                # u8 camera frames stay u8 across any upload here.
                of = (torch.as_tensor(of_frames[0], device=self.device),
                      torch.as_tensor(of_frames[1], device=self.device),
                      float(u["offset"]), float(u["lambda"]),
                      float(u["speed"]))
            blur_t = None if blur is None else tuple(float(v) for v in blur)
            bokeh_t = (None if bokeh is None
                       else tuple(float(v) for v in bokeh))
            self.sim, screen = _frame_io(
                self.sim, x.params, x.time, x.dt, self.config,
                self._view_size, cm=cm, cm_alphas=color_alphas, seg=seg,
                of=of, blur=blur_t, bokeh=bokeh_t,
                stepping=not self.timer.paused, **x.switches())
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

    def set_color_map(self, color_map):
        """Replace the colour-map grid (`f32[4, h, w]`), the config's
        `color_map_res` following its shape — ref colorMap FBO
        `src/index.js:94-96`."""
        color_map = torch.as_tensor(color_map, dtype=torch.float32,
                                    device=self.device)
        if tuple(color_map.shape) != tuple(self.sim.color_map.shape):
            self.config = dataclasses.replace(
                self.config, color_map_res=tuple(color_map.shape[1:]))
        self.sim = dataclasses.replace(self.sim, color_map=color_map)
        return self

    # -- view helpers (ref src/index.js:342-391)

    def draw_fade(self):
        """Fade the current view buffer towards `fadeColor` (ref
        `src/index.js:342-356`)."""
        p = self.params()
        view0 = render.fade_fill(self.sim.view[0], p["fadeColor"])
        self.sim = dataclasses.replace(
            self.sim, view=with_view0(self.sim.view, view0))
        return self

    def copy_buffer(self, index=0):
        """A view buffer's contents as the screen output — ref
        `src/index.js:370-383` (`copyBuffer` blits buffer `index` into the
        bound target). Returns `f32[4, H, W]` (zeros past the ring)."""
        if index < self.config.num_view_buffers:
            return self.sim.view[index]
        return torch.zeros_like(self.sim.view[0])

    def draw_buffer(self, index=0):
        """`drawBuffer`: copy a buffer to the screen, then rotate the ring
        — ref `src/index.js:358-367`. Returns the screen image."""
        out = self.copy_buffer(index)
        self.step_buffers()
        return out

    def step_buffers(self):
        """Ring-rotate the view buffers — ref `src/index.js:385-391` +
        `src/utils/index.js:1-7`."""
        if self.config.num_view_buffers > 1:
            self.sim = dataclasses.replace(
                self.sim, view=torch.roll(self.sim.view, 1, dims=0))
        return self

    def resize(self, view_res, flow_res=None):
        """Reallocate the view and flow grids — ref `src/index.js:393-408`
        (their content is not kept, as an FBO reshape keeps none). The
        particles stay; the carried force and the merge carry go, and the
        carry is re-seeded for the new tile count (`reseed_derived`). The
        kernels read the padded dims and tile count from the grids' shapes
        at every call, and their kept scratch is keyed by shape."""
        self.config = dataclasses.replace(self.config,
                                          view_res=tuple(view_res),
                                          flow_res=flow_res)
        self._setup_static()
        cfg = self.config
        h, w = cfg.view_res
        fh, fw = cfg.flow_shape
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sim = dataclasses.replace(
            self.sim, view=torch.zeros((cfg.num_view_buffers, 4, h, w),
                                       **f32),
            flow=torch.zeros((4, fh, fw), **f32),
            force=None, sort_key=None, sort_hist=None)
        self.reseed_derived()
        return self

    @property
    def view_image(self):
        """Current view buffer as `f32[H, W, 4]`, row 0 at top (display)."""
        return self.sim.view[0].permute(1, 2, 0).flip(0)
