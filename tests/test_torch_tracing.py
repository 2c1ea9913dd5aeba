"""The port's spans (`utils.profiling.span`): a tiny resident frame on the
CPU under `torch.profiler` emits each layer's span inside its parent's,
names only spans of `profiling.SPANS`, and computes the same bits as
with no profiler; with none running a span is one shared null context.
With the merge reorder on, a merged frame records `draw.merge`, a
refused one `draw.fallback` too, and a frame with it off neither.
`profiling.by_span` attributes made-up device events to the innermost
span that launched them."""

import contextlib
import dataclasses
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import tendrils_tpu_torch as tt
from tendrils_tpu_torch.ops import draw_cuda
from tendrils_tpu_torch.spawners import spawn_ball
from tendrils_tpu_torch.utils import profiling

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2)
PARENTS = {"frame": None, "params": "frame", "logic": "frame",
           "draw": "frame", "draw.sort": "draw", "post": "frame"}


def _run(profiled):
    """A fresh engine, spawned; one `frame()`, `noiseScale` changed, one
    `step_draw_io` with the bokeh. Returns the state, the screen and the
    trace's events (None without the profiler)."""
    eng = tt.Tendrils(tt.EngineConfig(**CFG), device="cpu")
    eng.state["damping"] = 0.042
    eng.setup()
    spawn_ball(radius=0.6, speed=0.01).spawn(eng)
    ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
           else contextlib.nullcontext())
    with ctx as prof:
        eng.frame()
        eng.state["noiseScale"] = 2.5
        eng.timer.tick()
        screen = eng.step_draw_io(bokeh=(3.0, 40.0))
    return eng, screen, prof.events() if profiled else None


@pytest.fixture(scope="module")
def runs():
    return _run(True), _run(False)


def _spans(events):
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in events if ev.name.startswith(profiling.PREFIX)]


def test_the_frame_is_resident_in_gather_mode_1(runs):
    (eng, _, _), _ = runs
    cfg = eng.config
    assert tt.engine.resident_enabled(cfg)
    assert draw_cuda.gather_mode(
        cfg.n, draw_cuda.seg_tile_count(cfg.view_res), ids=True,
        resident=True, idx_bound=cfg.n) == 1


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_emitted_inside_its_parent(runs, name):
    (_, _, events), _ = runs
    spans = _spans(events)
    mine = [(s, e) for n, s, e in spans if n == "tt." + name]
    assert mine, f"no tt.{name}"
    parent = PARENTS[name]
    if parent is None:
        assert len(mine) == 2  # frame(), step_draw_io()
        return
    outer = [(s, e) for n, s, e in spans if n == "tt." + parent]
    for s, e in mine:
        assert any(ps <= s and e <= pe for ps, pe in outer), (name, s, e)


def test_emitted_names_are_the_vocabulary(runs):
    (_, _, events), _ = runs
    names = {n for n, _, _ in _spans(events)}
    assert names, "no span recorded"
    assert {n[len(profiling.PREFIX):] for n in names} <= set(profiling.SPANS)
    # A nested span's name extends its parent's.
    assert {n.rsplit(".", 1)[0] for n in profiling.SPANS if "." in n} \
        <= set(profiling.SPANS)


def test_no_profiler_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    assert isinstance(profiling.span("frame"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("frame") is not profiling.span("frame")


def test_frame_bit_equal_with_and_without_the_profiler(runs):
    (on, screen_on, _), (off, screen_off, _) = runs
    for f in dataclasses.fields(on.sim):
        a, b = getattr(on.sim, f.name), getattr(off.sim, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        else:
            assert torch.equal(a, b), f.name
    assert torch.equal(screen_on, screen_off)


@pytest.fixture(scope="module")
def merge_frames():
    """The merge's spans, a frame each: with the merge on at 16,384 rows
    (the fewest it admits), the frame after `reseed_derived` (every row
    churned: the merge is refused and the frame flat-sorts) and the next
    (merged); with it off, one frame. `{case: [(name, start, end)]}`."""
    out = {}
    for merge in (True, False):
        eng = tt.Tendrils(tt.EngineConfig(**dict(
            CFG, root_num=128, merge_reorder=merge)), device="cpu")
        eng.setup()
        spawn_ball(radius=0.6, speed=0.01).spawn(eng)
        eng.reseed_derived()
        for case in (("reseeded", "merged") if merge else ("off",)):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng.frame()
            out[case] = _spans(prof.events())
    return out


@pytest.mark.parametrize("case,want", [
    ("reseeded", {"draw.merge", "draw.fallback"}),
    ("merged", {"draw.merge"}),
    ("off", set()),
])
def test_the_merge_and_its_fallback_have_spans(merge_frames, case, want):
    spans = merge_frames[case]
    got = {n[len(profiling.PREFIX):] for n, _, _ in spans}
    assert got & {"draw.merge", "draw.fallback"} == want
    assert ("draw.wait" in got) == bool(want)
    # Each lies in the sort, the fallback after the merge's ok was read.
    sort = [(s, e) for n, s, e in spans if n == "tt.draw.sort"]
    at = {n: (s, e) for n, s, e in spans}
    for name in want | ({"draw.wait"} if want else set()):
        s, e = at["tt." + name]
        assert any(ps <= s and e <= pe for ps, pe in sort), name
    if "draw.fallback" in want:
        assert at["tt.draw.merge"][1] <= at["tt.draw.wait"][0]
        assert at["tt.draw.wait"][1] <= at["tt.draw.fallback"][0]


def _ev(name, start, end, cid=0, device=DeviceType.CPU, annotation=False):
    return types.SimpleNamespace(
        name=name, id=cid, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_by_span_attributes_to_the_innermost_launching_span():
    cuda = DeviceType.CUDA
    events = [
        _ev("tt.frame", 0, 100), _ev("tt.params", 1, 20),
        _ev("cudaMemcpyAsync", 2, 3, cid=7), _ev("cudaStreamSynchronize",
                                                  3, 18, cid=8),
        _ev("tt.logic", 20, 50), _ev("aten::add", 21, 30),
        _ev("cudaLaunchKernel", 22, 23, cid=9),
        _ev("cudaLaunchKernel", 24, 25, cid=10),
        _ev("cudaLaunchKernel", 60, 61, cid=11),
        _ev("cudaLaunchKernel", 200, 201, cid=12),
        # The device side: a copy, kernels (two overlapping), annotations.
        _ev("Memcpy HtoD", 10, 12, cid=7, device=cuda),
        _ev("add_kernel", 30, 40, cid=9, device=cuda),
        _ev("mul_kernel", 35, 45, cid=10, device=cuda),
        _ev("draw_glue", 70, 75, cid=11, device=cuda),
        _ev("loose", 205, 206, cid=12, device=cuda),
        _ev("tt.logic", 30, 45, device=cuda, annotation=True),
    ]
    got = profiling.by_span(events)
    assert got["tt.params"].sync_us == 15 and got["tt.params"].launches == 0
    assert got["tt.params"].device == [(10, 12)]
    assert got["tt.logic"].launches == 2
    assert got["tt.logic"].device_us == 15  # the union of 30-40 and 35-45
    assert got["tt.logic"].host_us == 30 and got["tt.logic"].calls == 1
    assert got["tt.frame"].device == [(70, 75)]
    assert got["tt.frame"].launches == 1
    assert got[None].device == [(205, 206)] and got[None].launches == 1


@pytest.mark.parametrize("times,want", [
    ([0.5, 1.5, 2.5, 4.5, 9.0], ["a", "b", "c", "a", None]),
    ([3.0, 2.0], ["a", "c"]),
])
def test_innermost_of_nested_spans(times, want):
    spans = [("a", 0, 5), ("b", 1, 2), ("c", 2, 3)]
    assert profiling.innermost(spans, times) == want
