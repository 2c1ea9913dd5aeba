"""The plain reference: the benchmark's own implementation of one frame,
in plain PyTorch, transcribed from the JAX package's semantics (`logic`:
the set-up and the logic step; `draw`: the resident frame's fused draw,
resolve and carried-force gather; `post`: the bokeh). It imports nothing
of the program, JAX or the JAX package.

The engine is chaotic: two float orders part within a few hundred frames,
so the reference follows the program frame by frame. It checks the
window's last frame from the program's state before it, in two stages,
each from the program's own input to it:

  step  from the state before the frame: the force gathered from its flow
        grid, the logic step, the state reassembled as the resident frame
        does (q15 velocity, prev = pos - vel, mode 3's cleared bits);
  draw  from the stepped particles the program returned (judged by the
        step's comparison): the flow and view grids, the next step's
        force and, where the mix has one, the screen.

A frame before which the mix respawns the particles (`traffic.respawns`)
starts from the respawned state (`Frame.enter`): the ball by row, from
each row's id; previous the particles before it; no carried force, so the
step gathers its force from the flow at the ball's positions, decayed to
the frame's time (K5's semantics, `engine._step_force`).

The draw takes the program's stepped positions because the splat places
its samples on a grid of 1/pscale px: a position one float32 rounding
away lands a sample in the next quantum wherever it lies within that
rounding of a boundary, and moves its whole deposit. `start` sets the
state up from the seed as the configuration states; the state the window
starts from is compared with it apart. Each frame's time comes from the
frame's number alone.

`lowp` selects a control in the program's place: "bf16", the whole frame
with its state, parameters and outputs in bfloat16 (the precision below
the configurations' float32); "draw-bf16", the draw's sums and outputs
in bfloat16 over a float32 step.
"""

import torch

from benchmark import traffic
from benchmark.reference import draw as draw_mod
from benchmark.reference import logic, post

F32 = torch.float32


def bf16(t):
    """A float tensor rounded to bfloat16 and back; anything else as is."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(torch.bfloat16).to(t.dtype)
    return t


def fields(sim):
    """A state's tensors by field name (no copies)."""
    return dict(vars(sim))


def _identity(x, idx):
    """Rows `x[..., r]` placed at their particle's id `idx[r]`."""
    out = torch.empty_like(x)
    out[..., idx.long()] = x
    return out


def start(config, seed, device, lowp=None):
    """The state set up from the seed, `{field: tensor}`: the spawn, its
    rows in the seed's order (`traffic.row_order`)."""
    e, sp = config["engine"], config["spawn"]
    out = logic.start(e["root_num"], tuple(e["view_res"]), sp["radius"],
                      sp["speed"], device)
    order = traffic.row_order(seed, out["idx"].numel(), device)
    for f in traffic.ROW_FIELDS:
        out[f] = out[f][..., order]
    return {k: bf16(v) for k, v in out.items()} if lowp == "bf16" else out


def frame_time(config, spec, i):
    """`(time, dt)` of frame `i` of mix `spec`: the timer starts at 0, the
    spawn ticks it once, each respawn and each frame once more before the
    frame runs."""
    dt = config["dt_ms"]
    return logic.ticks_time(0.0, dt, i + 2 + traffic.respawns_through(spec,
                                                                       i)), dt


class Frame:
    """Frame `i` of mix `spec` on configuration `config`, as the reference
    works it out: its parameters, times and sizes."""

    def __init__(self, config, spec, i, device, lowp=None):
        self.config, self.spec, self.lowp = config, spec, lowp
        e = config["engine"]
        self.root_num, self.samples = e["root_num"], e["view_samples"]
        h, w = e["view_res"]
        self.view_size = logic.cover_aspect(w, h).to(device)
        values = dict(config["state"])
        values.update(traffic.state(spec, i))
        self.p = logic.params(values, device)
        if lowp == "bf16":
            self.p = {k: bf16(v) for k, v in self.p.items()}
        self.respawn = traffic.respawns(spec, i)
        t, dt = frame_time(config, spec, i)
        t_prev, _ = frame_time(config, spec, i - 1)
        self.time = torch.tensor(t, dtype=F32, device=device)
        self.dt = torch.tensor(dt, dtype=F32, device=device)
        self.p["time"] = self.time
        self.p["read_time"] = self.time + self.dt
        self.prev_read = (torch.tensor(t_prev, dtype=F32, device=device)
                          + self.dt)

    def enter(self, sim_in):
        """The state the frame's step starts from: `sim_in` (`{field:
        tensor}`), on a respawn frame with the ball's particles by row and
        `previous` the particles before it, no force carried."""
        if not self.respawn:
            return sim_in
        r = self.spec["respawn"]
        ball = logic.ball(sim_in["idx"], self.root_num, r["radius"],
                          r["speed"])
        if self.lowp == "bf16":
            ball = bf16(ball)
        return dict(sim_in, particles=ball, previous=sim_in["particles"],
                    force=None)

    def step(self, sim_in):
        """The stepped state from the state before the frame (`{field:
        tensor}`, rows in any order): `{particles, previous, idx}`, rows
        in id order."""
        sim_in = self.enter(sim_in)
        idx = sim_in["idx"]
        pin = _identity(sim_in["particles"], idx)
        tin = _identity(sim_in["targets"], idx)
        flow = sim_in["flow"]
        if self.lowp == "bf16":
            pin, tin, flow = bf16(pin), bf16(tin), bf16(flow)
        h, w = flow.shape[1:]
        if self.respawn:
            # No carried force: gathered at the positions themselves from
            # the flow decayed to the frame's time.
            eff = draw_mod.decayed(flow.double(), self.time.double(),
                                   self.p["flowDecay"].double())
            x = (pin[0] * self.view_size[0] * 0.5 + 0.5) * w
            y = (pin[1] * self.view_size[1] * 0.5 + 0.5) * h
            force = draw_mod.sample(eff, x, y).to(F32)
        else:
            ps = draw_mod.pos_scale(h, w)
            xq, yq = draw_mod.p1_words(pin[:2], self.view_size, h, w, ps)
            eff = draw_mod.decayed(flow.double(), self.prev_read.double(),
                                   self.p["flowDecay"].double())
            force = draw_mod.gather(eff, xq, yq, ps).to(F32)
        ids = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device)
        pos, vel = logic.step(pin, force, tin, ids, self.p, self.time,
                              self.dt, self.root_num)
        particles, previous = logic.reassemble(pos, vel,
                                               self.p["speedLimit"])
        if self.lowp == "bf16":
            particles, previous = bf16(particles), bf16(previous)
        return {"particles": particles, "previous": previous, "idx": ids}

    def draw(self, sim_in, stepped):
        """The draw from the state before the frame and the stepped state
        (`{particles, idx}`, rows in any order): `{flow, view, force,
        idx}` (the force's rows in id order) and the screen or None."""
        sim_in = self.enter(sim_in)
        pin = _identity(sim_in["particles"], sim_in["idx"])
        out = _identity(stepped["particles"], stepped["idx"])
        p = dict(self.p)
        p["mapped"] = sim_in["color_map"][:, 0, 0] * p["colorMapAlpha"]
        lowp = self.lowp is not None
        res = draw_mod.frame_draw(pin[:2], out[:2], out[2:],
                                  sim_in["flow"], sim_in["view"][0], p,
                                  self.view_size, self.samples, lowp=lowp)
        res["view"] = res["view"][None]
        res["idx"] = torch.arange(out.shape[1], dtype=torch.int32,
                                  device=out.device)
        screen = None
        if self.spec.get("bokeh"):
            screen = post.bokeh(res["view"][0], *self.spec["bokeh"])
            if lowp:
                screen = bf16(screen)
        return res, screen
