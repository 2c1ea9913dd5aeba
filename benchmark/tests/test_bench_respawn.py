"""A mix that respawns the particles before every `every`-th frame
(`respawn` in its file), at a tiny size on the CPU: the generator's
schedule and calls, the reference's timer and ball against the port's,
and the check of the respawn frame after the window."""

import collections
import statistics
import types

import pytest
import torch

from benchmark import cell, check, faults, harness, reference, traffic
from conftest import tiny

SEED = 2 ** 31 + 21


class _Recorder:
    """An engine that records the calls a feed makes into it."""

    def __init__(self):
        self.calls = []
        rec = self.calls.append
        self.state = types.SimpleNamespace(
            update=lambda values: rec(("state", dict(values))))
        self.timer = types.SimpleNamespace(tick=lambda: rec(("tick",)))
        self.frame = lambda: rec(("frame",))
        self.step_draw_io = lambda **kw: rec(("step_draw_io", kw))
        self.spawn_shader = lambda op, target=None: rec(("spawn", target))


def _lib():
    """Program modules whose spawner records its uniforms."""
    def spawn_ball(radius, speed):
        return types.SimpleNamespace(
            spawn=lambda eng: eng.spawn_shader((radius, speed)))
    return types.SimpleNamespace(spawn_ball=spawn_ball)


@pytest.mark.parametrize("mix,per_frame", [
    ("headless", lambda i: [("state", {}), ("frame",)]),
    ("show", lambda i: [("state", {"noiseScale": 2.0 + 0.5 * (i % 3)}),
                        ("tick",), ("step_draw_io", {"bokeh": [3.0, 40.0]})]),
])
def test_a_mix_without_respawn_makes_the_same_calls(mix, per_frame):
    eng = _Recorder()
    feed = traffic.Feed(traffic.load(mix), eng)
    for i in range(25):
        feed.frame(i)
    assert eng.calls == [c for i in range(25) for c in per_frame(i)]
    assert not any(traffic.respawns(feed.spec, i) for i in range(100))


def test_the_respawn_schedule():
    spec = traffic.load("respawn")
    every = spec["respawn"]["every"]
    # The warm frames run one respawn frame, the last of them.
    assert spec["warm_frames"] == every + 1
    assert [i for i in range(4 * every + 5) if traffic.respawns(spec, i)] \
        == [every, 2 * every, 3 * every, 4 * every]
    spec = dict(spec, respawn=dict(spec["respawn"], every=10))
    assert [i for i in range(45) if traffic.respawns(spec, i)] == \
        [10, 20, 30, 40]
    assert [traffic.respawns_through(spec, i) for i in (-1, 0, 9, 10, 19,
                                                        20, 45)] == \
        [0, 0, 0, 1, 1, 2, 4]
    # The feed respawns, inside the frame's entry, exactly before those
    # frames; a warm stretch that reaches no multiple of `every` respawns
    # nowhere.
    for warm, want in ((3, []), (11, [10]), (25, [10, 20])):
        eng = _Recorder()
        feed = traffic.Feed(spec, eng, _lib())
        got = []
        for i in range(warm):
            n = len(eng.calls)
            feed.frame(i)
            calls = eng.calls[n:]
            if ("spawn", None) in calls:
                assert calls.index(("spawn", None)) < calls.index(("frame",))
                got.append(i)
        assert got == want


@pytest.mark.parametrize("bad", [{"every": 0}, {"every": 2.5}, None])
def test_a_respawn_the_generator_cannot_make_raises(bad):
    """A schedule that is no whole number above 0, or a respawning mix
    fed without the program's modules, raises."""
    spec = traffic.load("respawn")
    if bad is None:
        with pytest.raises(ValueError):
            traffic.Feed(spec, _Recorder())
        return
    spec["respawn"] = dict(spec["respawn"], **bad)
    with pytest.raises(ValueError):
        traffic.Feed(spec, _Recorder(), _lib())


def test_the_feed_times_each_respawn_on_the_host():
    """`spans["spawn"]` holds one host time a respawn, none for the other
    frames, and `spawn_host_ms` reads their mean; a window without a
    respawn gives it nothing to read."""
    spec = traffic.load("respawn")
    feed = traffic.Feed(spec, _Recorder(), _lib())
    spans = collections.defaultdict(list)
    every = spec["respawn"]["every"]
    for i in range(1, 3 * every + 1):
        feed.frame(i, spans=spans)
    assert len(spans["spawn"]) == 3 and len(spans["frame"]) == 3 * every
    ports = [spans["port"][i - 1] for i in (every, 2 * every, 3 * every)]
    assert all(0 <= s <= p for s, p in zip(spans["spawn"], ports))
    read = cell.reader("spawn_host_ms")
    view = types.SimpleNamespace(spans=dict(spans))
    assert read(view) == sum(spans["spawn"]) / 3 * 1e3
    assert read(types.SimpleNamespace(spans={"frame": [0.002]})) is None


def test_frame_time_is_the_ports_timer_through_respawns():
    c = tiny("tier1-respawn")
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, SEED, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    for i in range(23):
        feed.frame(i)
        t, dt = reference.frame_time(c.config, c.traffic, i)
        assert (eng.timer.time, eng.timer.dt) == (t, dt), i


def test_the_reference_respawn_is_the_ports_by_identity():
    c = tiny("tier1-respawn")
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, SEED, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    for i in range(3):
        feed.frame(i)
    before = reference.fields(eng.sim)
    r = c.traffic["respawn"]
    lib.spawn_ball(radius=r["radius"], speed=r["speed"]).spawn(eng)
    got = reference.fields(eng.sim)
    i = c.traffic["respawn"]["every"]
    want = reference.Frame(c.config, c.traffic, i, "cpu").enter(before)
    assert got["force"] is None and want["force"] is None
    for f in ("particles", "previous"):
        a = check.by_identity(got[f], got["idx"])
        b = check.by_identity(want[f], want["idx"])
        assert torch.equal(a, b), f
    assert not torch.equal(got["particles"], before["particles"])


def test_the_check_reads_the_respawn_frame_after_the_window():
    c = tiny("tier1-respawn")
    result, numbers, ctl = harness.run(c, SEED, 0.2, False, 0.0,
                                       device="cpu", controls=("bf16",))
    assert result["correct"], result["checks"]
    names = {"respawn", "spawn_particles", "spawn_previous", "spawn_force",
             "spawn_flow", "spawn_view"}
    assert names <= set(numbers) and names <= set(c.limits)
    assert names <= set(ctl["bf16"])
    assert numbers["respawn"] == 0.0
    assert ctl["bf16"]["respawn"] > c.limits["respawn"]


def test_a_skipped_respawn_fails_the_respawn_check():
    undo = faults.plant("respawn_skipped")
    try:
        result, numbers, _ = harness.run(tiny("tier1-respawn"), SEED, 0.2,
                                         False, 0.0, device="cpu")
    finally:
        undo()
    assert not result["correct"]
    assert numbers["start"] == 0.0
    assert numbers["respawn"] > 0.1
    assert numbers["spawn_particles"] > 0.1


def test_a_respawning_cell_reads_its_p95_per_layer():
    """The respawning cell holds no end-to-end `frame_ms_p95`; its traced
    run reports the same percentile as `frame_ms_p95.respawn`."""
    c = tiny("tier1-respawn")
    result, _, _ = harness.run(c, SEED, 0.2, False, 0.0, device="cpu")
    assert "frame_ms" in result["metrics"]
    assert "frame_ms_p95" not in result["metrics"]
    result, _, _ = harness.run(c, SEED, 0.4, True, 0.0, device="cpu")
    assert result["metrics"]["frame_ms_p95.respawn"]["value"] > 0


def test_the_traced_stretch_is_one_interval_the_p95_leaves_out():
    c = tiny("tier1-respawn")
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, SEED, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    clock = harness.Clock(torch.device("cpu"))
    w = harness.run_window(feed, eng, 0, 0.4, clock, True,
                           collections.Counter())
    assert w.stretches
    assert len(w.intervals_ms) == (
        w.frames - (harness.PROFILED - 1) * len(w.stretches))
    rest = [v for k, v in enumerate(w.intervals_ms) if k not in w.stretches]
    assert all(w.intervals_ms[k] > 3 * statistics.median(rest)
               for k in w.stretches)
