"""The one traffic generator: reads a mix's parameters from
`benchmark/traffic/<name>.json` and feeds an engine frame by frame.

A mix's file may hold:
  entry        "frame" (`Tendrils.frame()`) or "step_draw_io" (a timer
               tick, then `Tendrils.step_draw_io`);
  warm_frames  frames of the mix run in set-up, before the window;
  state_cycle  `{key, base, step, period}`: the state key set to
               `base + step * (i mod period)` before frame i;
  bokeh        the post stage's `(radius, amount)`;
  respawn      `{every, radius, speed}`: before frame i, where i > 0 and
               i mod every = 0, the particles are respawned in a ball
               (`spawn_ball(radius, speed)`, which ticks the timer once),
               inside the entry's span.
"""

import contextlib
import json
import pathlib
import time

import torch

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"
# The state's fields that hold a row a particle, in the rows' order.
ROW_FIELDS = ("particles", "previous", "targets", "idx")


def load(name):
    """The parameters of traffic mix `name`."""
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def row_order(seed, n, device):
    """The order of the spawned particles' rows, from the seed: a
    permutation of `n` drawn on `device` by a generator that `seed` seeds.
    Every seed runs the same particles, and so the same work, in another
    order: a frame's result by particle does not depend on its rows'
    order (the sums are exact in int64), while a draw of other particles
    moves the flow's later clustering and with it the frame time."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randperm(n, generator=g, device=device)


def state(spec, i):
    """The state values mix `spec` sets before frame `i`."""
    c = spec.get("state_cycle")
    if not c:
        return {}
    return {c["key"]: c["base"] + c["step"] * (i % c["period"])}


def respawns(spec, i):
    """Whether mix `spec` respawns the particles before frame `i`."""
    r = spec.get("respawn")
    return bool(r) and i > 0 and i % r["every"] == 0


def respawns_through(spec, i):
    """The respawns of mix `spec` before frames 0 to `i`."""
    r = spec.get("respawn")
    return max(i, 0) // r["every"] if r else 0


class Feed:
    """Feeds one engine the mix's inputs, a frame a call. Records, with
    `spans`, the host seconds of each frame's calls into the engine
    (`frame`), of the entry alone (`port`, the respawn included) and of
    the respawn (`spawn`, in the frames that have one). `lib`: the
    program's modules (`harness.program_lib()`), which a mix that respawns
    needs. With `keep_spawned` set, `spawned` holds the state a respawn
    left, before the frame's entry ran on it."""

    def __init__(self, spec, eng, lib=None):
        self.spec, self.eng = spec, eng
        self.io = spec["entry"] == "step_draw_io"
        if spec["entry"] not in ("frame", "step_draw_io"):
            raise ValueError(f"unknown entry: {spec['entry']}")
        self.spawner = None
        r = spec.get("respawn")
        if r:
            if not (isinstance(r["every"], int) and r["every"] > 0):
                raise ValueError(f"respawn every: {r['every']!r}, not a "
                                 "whole number above 0")
            if lib is None:
                raise ValueError("a mix that respawns needs the program's "
                                 "modules (`lib`)")
            self.spawner = lib.spawn_ball(radius=r["radius"],
                                          speed=r["speed"])
        self.keep_spawned, self.spawned = False, None
        # `mark(name)`: a context around the entry call, for the traced
        # stretch's spans (`bench.<name>`).
        self.mark = lambda name: contextlib.nullcontext()

    def frame(self, i, spans=None):
        """Run frame `i`; returns the post stage's screen or None."""
        eng, spec = self.eng, self.spec
        clock = time.perf_counter
        t0 = clock()
        eng.state.update(state(spec, i))
        t1 = clock()
        with self.mark("port"):
            if self.spawner is not None and respawns(spec, i):
                with self.mark("spawn"):
                    self.spawner.spawn(eng)
                if spans is not None:
                    spans["spawn"].append(clock() - t1)
                if self.keep_spawned:
                    self.spawned = eng.sim
            if self.io:
                eng.timer.tick()
                screen = eng.step_draw_io(bokeh=spec.get("bokeh"))
            else:
                screen = None
                eng.frame()
        t2 = clock()
        if spans is not None:
            spans["frame"].append(t2 - t0)
            spans["port"].append(t2 - t1)
        return screen
