"""Row-slab grids: the port of `tendrils_tpu/parallel/spatial.py` on
`torch.distributed`.

The data-parallel layout (`parallel.sharding`) keeps the whole flow and
view grids on every rank and sums whole-grid splat sums. This layout
keeps the particles data-parallel but splits the GRIDS into row slabs,
rank r of D holding rows r H / D to (r + 1) H / D:

  - each rank splats its own particles into whole-grid parts (a particle
    may deposit anywhere), widens them where a line is wider than the
    kernel's, and `comm.reduce_scatter_rows` sums them over the ranks, each
    keeping its slab (one collective for both passes' 12 channels);
  - each rank resolves (`composite_over`) and stores its slab alone;
  - the step's flow read `comm.all_gather_rows` the 2 channels of the
    decayed flow, not the 4-channel grid: at step time without a carried
    force, or at the end of the draw where the frame carries the force
    (the fused draw's sorted stream is the gather's bins: K7 and the
    un-sort, `engine.force_from_aux`).

The JAX module claims 0.583x the bytes of the data-parallel psum
(`spatial.py:22-27`, a count of its HLO's collectives on 8 TPU devices);
the port counts its own in `comm`. Constraints (`_check`): one grid shape
(`flow_res` None or `view_res`), H divisible by the ranks, one view
buffer, one flow level; each raises `ValueError`.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import state as state_mod
from ..const import INERT
from ..engine import (EngineConfig, _decayed, carry_enabled, force_from_aux,
                      with_view0)
from ..ops import coords, flow as flow_ops, logic_cuda, render, sample
from ..ops import splat as splat_ops
from ..ops.draw_cuda import _widen_excess, fused_draw_accumulate
from ..ops.gather_cuda import bilinear_gather
from . import comm
from .sharding import (GRID_FIELDS, ROW_FIELDS, broadcast_state, make_mesh,
                       mesh_group, row_block)


def _check(cfg: EngineConfig, ranks):
    """Raise `ValueError` unless the slab layout takes `cfg` over `ranks`
    ranks (`spatial.py:136-139`)."""
    h, _ = cfg.view_res
    if cfg.flow_shape != cfg.view_res:
        raise ValueError("slab mode shares one grid shape (flow_res is "
                         "view_res)")
    if h % ranks:
        raise ValueError(f"H={h} not divisible by {ranks} ranks")
    if cfg.num_view_buffers != 1:
        raise ValueError("slab mode takes one view buffer")
    if cfg.flow_levels != 1:
        raise ValueError("slab mode takes one flow level")
    if cfg.n % ranks:
        raise ValueError(f"particle count {cfg.n} not divisible by {ranks} "
                         "ranks")


def shard_sim_spatial(sim, mesh):
    """This rank's share of a SimState with row-slab grids: rank 0's state
    (broadcast), its block of rows and its slab of the flow and view grid
    rows; the colour map whole. The carried force and the merge-reorder
    carry are dropped (the slab frame keeps the row order)."""
    group = mesh_group(mesh)
    sim = broadcast_state(dataclasses.replace(
        sim, force=None, sort_key=None, sort_hist=None), group,
        ROW_FIELDS + GRID_FIELDS)
    lo, hi = row_block(sim.particles.shape[1], group)
    r0, r1 = row_block(sim.flow.shape[1], group)
    kw = {f: getattr(sim, f)[..., lo:hi].contiguous() for f in ROW_FIELDS}
    return dataclasses.replace(
        sim, flow=sim.flow[:, r0:r1].contiguous(),
        view=sim.view[:, :, r0:r1].contiguous(), **kw)


def _slab_step(sim, params, time, dt, cfg: EngineConfig, view_size, group):
    """The slab frame's logic step (K13 on this rank's rows): the force
    carried from the previous frame, else gathered from the all-gathered
    2-channel decayed flow, K5 on the "kernel" gather backend, the plain
    bilinear sample on "xla" (decayed, then interpolated, on both)."""
    h, w = cfg.view_res
    if sim.force is not None:
        force = sim.force
    else:
        eff = comm.all_gather_rows(_decayed(sim.flow, time, params), group)
        gather = bilinear_gather if cfg.gather_backend == "kernel" \
            else sample.bilinear_sample
        pos = sim.particles[:2]
        pos_screen = torch.stack([pos[0] * view_size[0],
                                  pos[1] * view_size[1]], dim=-1)
        u = pos_screen * 0.5 + 0.5
        force = gather(eff, u[:, 0] * w, u[:, 1] * h)
    new_particles = logic_cuda.logic_step(
        sim.particles, sim.targets, sim.idx, force, params, time, dt,
        cfg.root_num)
    return dataclasses.replace(sim, particles=new_particles,
                               previous=sim.particles, force=None)


def _scatter_parts(group, flow_parts, view_parts):
    """Both passes' whole-grid parts `(num, wsum, logt)`, summed over the
    ranks into this rank's slab: one reduce-scatter of the 12 channels."""
    stack = torch.cat([torch.cat([num, wsum[None], logt[None]])
                       for num, wsum, logt in (flow_parts, view_parts)])
    slab = comm.reduce_scatter_rows(stack, group)
    c = flow_parts[0].shape[0]
    v = c + 2
    return ((slab[:c], slab[c], slab[c + 1]),
            (slab[v:v + c], slab[v + c], slab[v + c + 1]))


def spatial_frame(sim, params, time, dt, cfg: EngineConfig, view_size, mesh,
                  host_widths=None):
    """One step + draw frame with row-slab grids (see the module
    docstring), on this rank's share (`shard_sim_spatial`). On the fused
    kernel draw (`fused_draw`, the "kernel" splat) the parts come from
    K1, the sort and K2 over the whole grid, at the fixed-point steps of
    the frame's `cfg.n` rows, and with the carried force
    (`engine.carry_enabled`) the frame carries this rank's force; else
    both passes splat with the f32 scatter. `host_widths`: the host's
    `(flowWidth, lineWidth)`, which decide the widening of the kernel
    draw's parts (read back from `params` when not given)."""
    group = mesh_group(mesh)
    _check(cfg, mesh.size())
    h, w = cfg.view_res
    sim = _slab_step(sim, params, time, dt, cfg, view_size, group)
    colormap_uv = state_mod.particle_coords_from_idx(sim.idx,
                                                     cfg.root_num)[2]
    pos = sim.particles[:2]
    vel = sim.particles[2:]
    prev_pos = sim.previous[:2]
    live = (((pos[0] != INERT) | (pos[1] != INERT))
            & ((prev_pos[0] != INERT) | (prev_pos[1] != INERT))).to(
                torch.float32)
    p0 = coords.clip_to_pixel(torch.stack(
        [prev_pos[0] * view_size[0], prev_pos[1] * view_size[1]], dim=-1),
        (w, h))
    p1 = coords.clip_to_pixel(torch.stack(
        [pos[0] * view_size[0], pos[1] * view_size[1]], dim=-1), (w, h))
    view0 = render.fade_fill(sim.view[0] * (1.0 - params["autoClearView"]),
                             params["fadeColor"] * params["autoFade"])
    carry = carry_enabled(cfg)
    aux = None
    if cfg.splat_backend == "kernel" and cfg.fused_draw:
        n_local = pos.shape[1]
        mapped = sample.sample_uv(sim.color_map, colormap_uv.T) \
            * params["colorMapAlpha"]
        fp, vp, aux, _ = fused_draw_accumulate(
            (h, w), p0, p1, vel, pos, mapped, live, params["speedLimit"],
            time, samples=cfg.view_samples,
            idx=(torch.arange(n_local, dtype=torch.int32, device=pos.device)
                 if carry else None),
            flow_width=params["flowWidth"], line_width=params["lineWidth"],
            speed_alpha=params["speedAlpha"],
            sin_decay=torch.sin(time * params["flowDecay"]),
            flow_decay=params["flowDecay"], base_color=params["baseColor"],
            flow_color=params["flowColor"], adds_rows=cfg.n)
        # The widening blurs across slab rows: applied to the whole parts
        # (it is linear, so it commutes with the sum) before the scatter.
        fw, lw = host_widths or (params["flowWidth"], params["lineWidth"])
        flow_parts, view_parts = _widen_excess(fp, fw), _widen_excess(vp, lw)
    else:
        payload = flow_ops.flow_payload(vel, time, params["speedLimit"])
        flow_parts = splat_ops.splat_segments_accumulate(
            p0, p1, payload, payload[3] * live, grid_hw=(h, w),
            width=params["flowWidth"], samples=cfg.flow_samples,
            rows=cfg.flow_rows, backend="xla")
        colors = render.particle_colors(pos, vel, colormap_uv,
                                        sim.color_map, params, time)
        view_parts = splat_ops.splat_segments_accumulate(
            p0, p1, colors, colors[3] * live, grid_hw=(h, w),
            width=params["lineWidth"], samples=cfg.view_samples,
            rows=cfg.view_rows, backend="xla")
    flow_parts, view_parts = _scatter_parts(group, flow_parts, view_parts)
    new_flow = splat_ops.composite_over(sim.flow, *flow_parts)
    view0 = splat_ops.composite_over(view0, *view_parts)
    sim = dataclasses.replace(sim, flow=new_flow,
                              view=with_view0(sim.view, view0))
    if aux is not None:
        # The next step's force now: the step's all-gather moves here, and
        # the draw's sort has binned the stream for the keyed gather.
        read_time = time + dt
        eff = comm.all_gather_rows(_decayed(new_flow, read_time, params),
                                   group)
        sim = dataclasses.replace(sim, force=force_from_aux(
            None, aux, params, read_time, cfg, eff=eff))
    return sim


class SpatialTendrils:
    """Engine facade over ranks with row-slab grids (`spatial_frame`)."""

    def __init__(self, engine, mesh=None):
        self.engine = engine
        self.mesh = mesh if mesh is not None \
            else make_mesh(engine.device.type)
        _check(engine.config, self.mesh.size())
        engine.sim = shard_sim_spatial(engine.sim, self.mesh)

    def frame(self):
        """tick + the slab frame (no `flow_off`, as the JAX facade)."""
        eng = self.engine
        eng.timer.tick()
        eng._check_force_params()
        if eng.timer.paused:
            return self
        x = eng._frame_inputs()
        eng.sim = spatial_frame(
            eng.sim, x.params, x.time, x.dt, eng.config, eng._view_size,
            self.mesh, host_widths=x.host_widths)
        return self
