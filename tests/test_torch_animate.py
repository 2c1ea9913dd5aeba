"""The port's animation engine (`tendrils_tpu_torch/animate/`, a copy of the
JAX package's pure-Python modules) against the JAX package's on the same
numpy-seeded inputs: tweens and eases, `join_curve`, `Timeline` seek and
play with the accumulation of skipped frames' `to`s and `call`s, the
`Timeline` editing API and `Player`.

Tolerance: none. Both run the same Python arithmetic on the same floats,
so every value must be equal (`==`).
"""

import math

import numpy as np
import pytest

from tendrils_tpu import animate as janim
from tendrils_tpu_torch import animate as tanim

SEEDS = [0, 1, 2]


def _both():
    return janim, tanim


def _ease(rng):
    """A random ease curve: None, or 1 to 5 control points."""
    k = int(rng.integers(0, 6))
    return None if k == 0 else [float(v) for v in rng.uniform(-0.5, 1.5, k)]


def _frames(rng, n, keys=("x", "y", "z")):
    """`n` keyframes at random times with random `to`s and eases, as
    plain tuples (each package builds its own frames)."""
    out = []
    for _ in range(n):
        to = {k: float(rng.uniform(-10, 10)) for k in keys
              if rng.uniform() < 0.8}
        out.append((to, float(rng.uniform(0, 1000)), _ease(rng)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_tweens_and_eases_match_jax(seed):
    """`bezier_ease`, `tween_value`, `tween_props` (dicts and lists, the
    output's own values as defaults) and the span form of `tween`."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ease, t = _ease(rng), float(rng.uniform(0, 1))
        a, b = (float(v) for v in rng.uniform(-5, 5, 2))
        pts = [float(v) for v in rng.uniform(-1, 2, int(rng.integers(0, 7)))]
        assert janim.bezier_ease(pts, t) == tanim.bezier_ease(pts, t)
        assert janim.tween_value(a, b, t, ease) == \
            tanim.tween_value(a, b, t, ease)
        da = {k: float(v) for k, v in zip("abc", rng.uniform(-5, 5, 3))}
        db = {k: float(v) for k, v in zip("abcd", rng.uniform(-5, 5, 4))}
        db["name"] = "s"
        outs = [{"d": 1.5} for _ in range(2)]
        got = [m.tween(da, db, t, ease, o) for m, o in zip(_both(), outs)]
        assert got[0] == got[1]
        la = [float(v) for v in rng.uniform(0, 1, 4)]
        lb = [float(v) for v in rng.uniform(0, 1, 4)]
        outs = [[0.0] * 2 for _ in range(2)]
        assert [m.tween_props(la, lb, t, ease, o)
                for m, o in zip(_both(), outs)] == [outs[0], outs[0]]
        assert outs[0] == outs[1]
        span = {"a": da, "b": db, "t": t, "ease": ease}
        assert janim.tween(span, {}) == tanim.tween(dict(span), {})


def test_join_curve_and_frame_match_jax():
    rng = np.random.default_rng(3)
    for k in range(6):
        curve = [float(v) for v in rng.uniform(-1, 2, k)] or None
        for align in (1, -1, 0.5):
            assert janim.join_curve(curve, align) == \
                tanim.join_curve(curve, align)
    fr = {"to": {"x": 1.0}, "time": 5.0, "ease": None, "call": None}
    assert janim.frame(fr) is fr and tanim.frame(fr) is fr
    assert janim.frame({"x": 2.0}, 3.0, [0, 1]) == \
        tanim.frame({"x": 2.0}, 3.0, [0, 1])


def _timeline(mod, frames, **kw):
    tl = mod.Timeline([mod.frame(to, t, e) for to, t, e in frames], **kw)
    return tl


def _span_view(span):
    """A span without its frame dicts' identities: the values that a
    player reads."""
    if span is None:
        return None
    out = {k: v for k, v in span.items() if k not in ("past", "next",
                                                      "call")}
    for k in ("past", "next"):
        if k in span:
            out[k + "_time"] = span[k]["time"]
    out["calls"] = len(span.get("call") or [])
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rewind,symmetric", [(False, True), (True, True),
                                              (True, False)])
def test_timeline_seek_and_play_match_jax(seed, rewind, symmetric):
    """Seek to random times, then play forwards and backwards through
    them: the spans (past and next frames, t, ease, the accumulated
    `apply` of skipped frames) and the playhead's gap, time by time."""
    rng = np.random.default_rng(10 + seed)
    frames = _frames(rng, 8)
    tls = [_timeline(m, frames, rewind=rewind, symmetric=symmetric)
           for m in _both()]
    assert [f["time"] for f in tls[0].frames] == \
        [f["time"] for f in tls[1].frames]
    times = [float(v) for v in rng.uniform(-100, 1100, 30)]
    for t in times:
        assert _span_view(tls[0].seek(t)) == _span_view(tls[1].seek(t))
    for t in sorted(times) + sorted(times, reverse=True):
        spans = [tl.play(t) for tl in tls]
        assert _span_view(spans[0]) == _span_view(spans[1])
        assert tls[0].gap == tls[1].gap and tls[0].time == tls[1].time
    assert tls[0].start() == tls[1].start()
    assert tls[0].duration() == tls[1].duration()


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_calls_accumulate_as_jax(seed):
    """Frames with calls: playing across them with skipped frames fires
    the same calls in the same order on both, with the same outputs."""
    rng = np.random.default_rng(20 + seed)
    data = _frames(rng, 10)
    logs = ([], [])
    players = []
    for m, log in zip(_both(), logs):
        frames = []
        for i, (to, t, e) in enumerate(data):
            call = [lambda out, span, i=i, log=log: log.append(
                (i, dict(out)))]
            frames.append(m.frame(to, t, e, call))
        players.append(m.Player({"a": frames}, {"a": {}}))
    steps = np.sort(rng.uniform(0, 1000, 12))
    for t in steps:
        for p in players:
            p.play(float(t))
    assert logs[0] == logs[1] and len(logs[0]) > 0
    assert players[0].outputs == players[1].outputs


def test_timeline_editing_matches_jax():
    """`to`, `over`, the smooth and flip joins, `add_span` and every
    `splice` form, applied in one script to both."""
    tls = [m.Timeline([]) for m in _both()]
    for tl in tls:
        tl.to({"x": 2.0}, 200.0).smooth_to({"x": 1.0}, 100.0, [0, 0.3, 1])
        tl.flip_to({"x": 3.0}, 300.0, [0.1, 0.9])
        tl.over(50.0, {"x": 4.0}, 400.0).smooth_over(25.0, {"x": 5.0},
                                                     600.0)
        tl.flip_over(10.0, {"x": 6.0}, 650.0, [0.2, 0.5, 1])
    assert tls[0].frames == tls[1].frames
    for call in (lambda tl: tl.splice(2, 1),
                 lambda tl: tl.splice(-1, 2, {"to": {"x": 9.0},
                                              "time": 700.0}),
                 lambda tl: tl.splice_index(1),
                 lambda tl: tl.splice_at(350.0, 1),
                 lambda tl: tl.splice_span(100.0, 50.0)):
        assert call(tls[0]) == call(tls[1])
        assert tls[0].frames == tls[1].frames
    for t in (-5.0, 120.0, 500.0, 2000.0):
        assert tls[0].span_gap_at(t) == tls[1].span_gap_at(t)


@pytest.mark.parametrize("seed", SEEDS)
def test_player_matches_jax(seed):
    """A Player of three tracks (dict outputs, a colour list) through
    seek, play, play_from, start, end, duration and `apply_span`."""
    rng = np.random.default_rng(30 + seed)
    tracks = {"a": _frames(rng, 5), "b": _frames(rng, 3, ("u", "v"))}
    colours = [([float(v) for v in rng.uniform(0, 1, 4)],
                float(rng.uniform(0, 1000)), None) for _ in range(4)]
    players = []
    for m in _both():
        tr = {k: [m.frame(*f) for f in fs] for k, fs in tracks.items()}
        tr["colour"] = m.Timeline([m.frame(*f) for f in colours])
        players.append(m.Player(tr, {"a": {}, "b": {"u": 0.5},
                                     "colour": [0.0, 0.0, 0.0, 1.0]}))
    for t in [float(v) for v in rng.uniform(-50, 1050, 12)]:
        for p in players:
            p.seek(t)
        assert players[0].outputs == players[1].outputs
    for t in np.sort(rng.uniform(0, 1000, 12)):
        for p in players:
            p.play(float(t))
        assert players[0].outputs == players[1].outputs
    for p in players:
        p.play_from(800.0, 100.0)
    assert players[0].outputs == players[1].outputs
    assert [(p.start(), p.end(), p.duration()) for p in players][0] == \
        [(p.start(), p.end(), p.duration()) for p in players][1]
    assert math.isinf(players[1].start())
    span = {"apply": {0: 1.0}, "a": [0.0, 0.0], "b": [1.0, 2.0], "t": 0.25,
            "ease": [0, 0.5, 1]}
    assert janim.apply_span(dict(span), [0.0, 0.0]) == \
        tanim.apply_span(dict(span), [0.0, 0.0])
