"""Faults planted under the timed path, to show that the check fails them:
each patches one function of the program for the rest of the process
(`plant(name)`; the returned function undoes it). `readings.py --fault`
reads them on the card at a cell's own size, the CPU tests at a tiny
one. The benchmark's own runs plant none.

  step_unchanged       the logic step returns its state unchanged;
  half_the_particles   half of the particles left out of the draw;
  answer_altered       one particle's position altered where the frame
                       returns it;
  respawn_skipped      a respawn after the set-up's spawn ticks the timer
                       but leaves the state as it was (in a cell whose
                       mix respawns: `for_cell`).

A cell on one card has no exchange between chips to leave out.
"""

import dataclasses

NAMES = ("step_unchanged", "half_the_particles", "answer_altered",
         "respawn_skipped")


def for_cell(c):
    """The faults cell `c` (`cell.Cell`) can have."""
    return tuple(n for n in NAMES
                 if n != "respawn_skipped" or c.traffic.get("respawn"))


def _patch(mod, name, fn):
    real = getattr(mod, name)
    setattr(mod, name, fn(real))
    return lambda: setattr(mod, name, real)


def plant(name):
    """Plant fault `name`; returns the function that removes it."""
    import tendrils_tpu_torch.engine as engine
    if name == "step_unchanged":
        return _patch(engine, "step_sim",
                      lambda real: lambda sim, *a, **k: sim)
    if name == "half_the_particles":
        def half(real):
            def draw(flow, view, p0, p1, vel, pos, mapped, live, *a, **k):
                live = live.clone()
                live[live.shape[0] // 2:] = 0.0
                return real(flow, view, p0, p1, vel, pos, mapped, live,
                            *a, **k)
            return draw
        return _patch(engine, "fused_draw", half)
    if name == "answer_altered":
        def nudge(sim):
            p = sim.particles.clone()
            p[0, 0] += 1e-2
            return dataclasses.replace(sim, particles=p)

        undo = [_patch(engine, "_frame",
                       lambda real: lambda *a, **k: nudge(real(*a, **k)))]

        def io(real):
            def frame_io(*a, **k):
                sim, screen = real(*a, **k)
                return nudge(sim), screen
            return frame_io
        undo.append(_patch(engine, "_frame_io", io))
        return lambda: [u() for u in reversed(undo)]
    if name == "respawn_skipped":
        def skipped(real):
            def spawn_shader(self, op, target=None):
                if self.timer.time == 0:  # the set-up's spawn
                    return real(self, op, target)
                self.timer.tick()
                return self
            return spawn_shader
        return _patch(engine.Tendrils, "spawn_shader", skipped)
    raise ValueError(f"unknown fault: {name} (one of {NAMES})")
