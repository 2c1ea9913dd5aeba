"""The facade's frame entries assemble one frame (`engine._frame`): from
one spawned start on the CPU, `step_draw()`, `step_draw_io()` with no
inputs and `step_draw_io(bokeh=...)` leave bit-equal states, the carried
force and the merge-reorder carry included, on the resident frame, the
classic frame, `flowWeight == 0` and the merge reorder. Only the io
entry with the bokeh returns a screen."""

import dataclasses

import pytest
import torch

import tendrils_tpu_torch as tt
from tendrils_tpu_torch.spawners import spawn_ball

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2)
CASES = {
    "resident": (CFG, {}),
    "classic": (dict(CFG, resident_stream=False), {}),
    "flow_off": (CFG, {"flowWeight": 0.0}),
    # 16,384 rows: the fewest the merge admits.
    "merge": (dict(CFG, root_num=128, merge_reorder=True), {}),
}
FRAMES = 2
BOKEH = (3.0, 40.0)


def _clone(sim):
    return dataclasses.replace(sim, **{
        f.name: getattr(sim, f.name).clone()
        for f in dataclasses.fields(sim)
        if isinstance(getattr(sim, f.name), torch.Tensor)})


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and torch.equal(x, y), f.name
        else:
            assert x is None and y is None, f.name


@pytest.mark.parametrize("case", list(CASES))
def test_the_entries_run_one_frame(case):
    cfg, state = CASES[case]
    eng = tt.Tendrils(tt.EngineConfig(**cfg), device="cpu")
    eng.setup()
    eng.state.update(state)
    spawn_ball(radius=0.6, speed=0.01).spawn(eng)
    for _ in range(2):
        eng.frame()
    start, t0 = _clone(eng.sim), eng.timer.time
    entries = {"step_draw": lambda: eng.step_draw(),
               "step_draw_io": lambda: eng.step_draw_io(),
               "step_draw_io(bokeh)": lambda: eng.step_draw_io(bokeh=BOKEH)}
    sims = {}
    for name, entry in entries.items():
        eng.sim, eng.timer.time = _clone(start), t0
        for _ in range(FRAMES):
            eng.timer.tick()
            out = entry()
        screen = out if name.startswith("step_draw_io") else None
        assert (screen is not None) == (name == "step_draw_io(bokeh)")
        sims[name] = eng.sim
    want = sims.pop("step_draw")
    assert (want.force is None) == (case == "flow_off")
    assert (want.sort_key is None) == (case != "merge")
    for got in sims.values():
        _assert_same(got, want)
