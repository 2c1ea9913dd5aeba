"""The preset corridors of tests/test_preset_corridors.py on the port's
demo on the "xla" backends, the generic draw: every band of `BANDS`
(alive fraction, mean alive speed, view and flow mass at frames 10, 30
and 60 of five presets, by its `stats`) and of `POST_BANDS` (the
post-processed screen's masses for `Pissarides` with the bokeh on),
imported unchanged, at the corridors' own size (90x160, `root_num=32`,
seed 0, 60 frames).

The bands were recorded on the JAX package's xla backend, so the port's
demo on that backend is held to all 66 of them as they stand, with no
JAX run. (On the kernel backends the JAX demo itself leaves 22 of them;
tests/test_torch_app_corridors.py holds the port's kernel demo to that
path.)
"""

import numpy as np
import pytest
import torch

from tendrils_tpu_torch.app.demo import TendrilsDemo
from test_preset_corridors import BANDS, POST_BANDS, stats

SIZE = dict(view_res=(90, 160), root_num=32, seed=0,
            splat_backend="xla", gather_backend="xla")
FRAMES = 60


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tiny tensors (1,024 particles):
    beside other test workers, a thread pool per op only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(preset, frames, read, bokeh=False):
    demo = TendrilsDemo({"quality": 0}, device="cpu", **SIZE)
    demo.apply_preset(preset)
    if bokeh:
        # apply_preset resets bokeh to its (off) default: layer it back on,
        # as tests/test_preset_corridors.py does.
        demo.bokeh_state.update(radius=3.0, amount=40.0)
    out = {}
    for f in range(1, FRAMES + 1):
        demo.render()
        if f in frames:
            out[f] = read(demo)
    return out


def _inside(bands, got, label):
    for f, band in bands.items():
        for k, (lo, hi) in band.items():
            assert lo <= got[f][k] <= hi, (
                f"{label} frame {f}: {k}={got[f][k]:.6g} outside "
                f"[{lo:.6g}, {hi:.6g}]")
    return sum(len(b) for b in bands.values())


@pytest.mark.parametrize("preset", list(BANDS))
def test_preset_corridor(preset):
    assert _inside(BANDS[preset], _run(preset, set(BANDS[preset]), stats),
                   preset) == 12


def test_post_stack_corridor():
    def post_stats(demo):
        screen = np.asarray(demo.screen)
        return {"rgb_mass": float(np.abs(screen[:3]).sum()),
                "alpha_mass": float(np.abs(screen[3]).sum())}

    assert _inside(POST_BANDS, _run("Pissarides", set(POST_BANDS),
                                    post_stats, bokeh=True), "post") == 6
