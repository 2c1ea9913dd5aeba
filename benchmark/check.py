"""The comparison that decides `correct`: the program's last frame against
the plain reference's (`benchmark/reference/`), each compared quantity as
one number held to its limit (`benchmark/limits/<cell>.json`).

A number is the widest relative gap of a quantity: over each channel (a
row of the particles, a plane of a grid), the largest |program -
reference| over the largest |reference| of that channel, and the largest
of those. Particle rows are compared by identity (`idx`, the row order a
resident frame sorts), and a row order that is no permutation, or a gap
that is not finite, reads infinity. `start` compares digests of the
state the program set up against the reference's.

In a mix that respawns the particles, a run also follows the first
respawn frame after the window (`spawn_numbers`): `respawn`, the state the
respawn left against the reference's ball, and that frame's numbers again
under `spawn_<name>`.
"""

import math

import torch

from benchmark import reference

TINY = 1e-30


def _channels(t):
    """`t` as `[channels, values]`: a particle tensor's rows, a grid's
    planes (`[..., H, W]`)."""
    if t.dim() >= 3:
        return t.reshape(-1, t.shape[-2] * t.shape[-1])
    return t.reshape(t.shape[0], -1)


def gap(got, want):
    """The widest relative gap of `got` from `want` (see the module)."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else math.inf
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    g, w = _channels(got).double(), _channels(want).double()
    d = (g - w).abs().amax(1)
    scale = w.abs().amax(1).clamp_min(TINY)
    out = (d / scale).max().item()
    return out if math.isfinite(out) else math.inf


def by_identity(x, idx):
    """The rows `x[:, r]` placed at their particle's id `idx[r]`; None if
    `idx` is no permutation of the rows."""
    if x is None:
        return None
    n = x.shape[-1]
    ids = idx.long()
    seen = torch.zeros(n, dtype=torch.bool, device=x.device)
    seen[ids] = True
    if ids.numel() != n or not bool(seen.all()):
        return None
    out = torch.empty_like(x)
    out[..., ids] = x
    return out


ROW_FIELDS = ("particles", "previous", "force")
GRID_FIELDS = ("flow", "view")


def compare(prog, ref, prog_screen=None, ref_screen=None):
    """`{name: gap}` of the program's state (and screen) after a frame
    against the reference's. `prog`, `ref`: `{field: tensor}`."""
    out = {}
    for f in ROW_FIELDS:
        if prog.get(f) is None and ref.get(f) is None:
            continue
        a = by_identity(prog.get(f), prog["idx"])
        b = by_identity(ref.get(f), ref["idx"])
        out[f] = math.inf if a is None or b is None else gap(a, b)
    for f in GRID_FIELDS:
        out[f] = gap(prog[f], ref[f])
    if prog_screen is not None or ref_screen is not None:
        out["screen"] = gap(prog_screen, ref_screen)
    return out


DIGEST_FIELDS = ("particles", "previous", "targets", "flow", "view",
                 "color_map", "idx")


def digest(fields):
    """Two float64 sums of each tensor of a state, `{field: (sum |t|, sum
    |t| r, sum t r)}` with r a ramp over [1, 2] in storage order: equal
    states give equal digests, and a reordering moves the last."""
    out = {}
    for f in DIGEST_FIELDS:
        t = fields[f].double().reshape(-1)
        r = torch.linspace(1.0, 2.0, t.numel(), dtype=torch.float64,
                           device=t.device)
        a = t.abs()
        out[f] = (a.sum().item(), (a * r).sum().item(), (t * r).sum().item())
    return out


def digest_gap(got, want):
    """The widest relative gap between two digests."""
    worst = 0.0
    for f, (s1, s1r, sr) in want.items():
        g1, g1r, gr = got[f]
        worst = max(worst, abs(g1 - s1) / max(abs(s1), TINY),
                    abs(gr - sr) / max(abs(s1r), TINY))
    return worst if math.isfinite(worst) else math.inf


def verdict(numbers, limits):
    """`(correct, checks)`: every limited number within its limit, a number
    the run did not read counting as a failure; `checks` each number
    beside its limit, in the limits' order."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks


def _follow(c, i, sim_in, out, screen, device):
    """The gaps of frame `i`'s output `out` (and screen) from the
    reference's, which follows the frame from `sim_in`."""
    if not (_sound(sim_in) and _sound(out)):
        # Rows that are no permutation of the ids, or positions that are
        # not finite, cannot feed the reference.
        gaps = {f: math.inf for f in ROW_FIELDS + GRID_FIELDS}
        if screen is not None or c.traffic.get("bokeh"):
            gaps["screen"] = math.inf
        return gaps
    fr = reference.Frame(c.config, c.traffic, i, device)
    ref = fr.step(sim_in)
    ref_draw, ref_screen = fr.draw(sim_in, out)
    ref.update(ref_draw)
    return compare(out, ref, screen, ref_screen)


def numbers(c, seed, i, sim_in, sim_out, screen, start_digest, device):
    """The compared numbers of cell `c`'s run: its frame `i` from the
    state before it (`sim_in`) to the state and screen it returned, and
    the digest of the state it set up, each against the reference."""
    out = _follow(c, i, sim_in, sim_out, screen, device)
    out["start"] = digest_gap(
        start_digest, digest(reference.start(c.config, seed, device)))
    return out


def spawn_numbers(c, i, sim_in, spawned, sim_out, screen, device):
    """The compared numbers of respawn frame `i`: `respawn`, the state the
    respawn left (`spawned`) against the reference's from the state before
    it (`sim_in`), by identity, particles and previous; then each of the
    frame's own numbers as `spawn_<name>`."""
    want = reference.Frame(c.config, c.traffic, i, device).enter(sim_in)
    out = {"respawn": max(
        gap(by_identity(spawned[f], spawned["idx"]),
            by_identity(want[f], want["idx"])) if _sound(spawned)
        else math.inf for f in ("particles", "previous"))}
    for k, v in _follow(c, i, sim_in, sim_out, screen, device).items():
        out[f"spawn_{k}"] = v
    return out


def _sound(sim):
    p = sim.get("particles")
    if p is None or by_identity(p, sim["idx"]) is None:
        return False
    return bool(torch.isfinite(p).all())


def _control(c, i, sim_in, kind, device):
    """The control `kind` (a `reference` lowp) in the program's place for
    frame `i`: `(the state its respawn left, if any, its output, its
    screen)`."""
    ctl = reference.Frame(c.config, c.traffic, i, device, lowp=kind)
    got = ctl.step(sim_in)
    got_draw, got_screen = ctl.draw(sim_in, got)
    got.update(got_draw)
    return ctl.enter(sim_in), got, got_screen


def control_numbers(c, seed, i, sim_in, kind, device):
    """The numbers of the control `kind` (a `reference` lowp) put in the
    program's place for frame `i` and the set-up."""
    _, got, got_screen = _control(c, i, sim_in, kind, device)
    out = _follow(c, i, sim_in, got, got_screen, device)
    out["start"] = digest_gap(
        digest(reference.start(c.config, seed, device, lowp=kind)),
        digest(reference.start(c.config, seed, device)))
    return out


def control_spawn_numbers(c, i, sim_in, kind, device):
    """The control `kind`'s numbers for respawn frame `i`, named as
    `spawn_numbers` names the program's."""
    spawned, got, got_screen = _control(c, i, sim_in, kind, device)
    return spawn_numbers(c, i, sim_in, spawned, got, got_screen, device)
