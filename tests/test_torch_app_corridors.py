"""The preset corridors of tests/test_preset_corridors.py on the port's
demo: `BANDS` (alive fraction, mean alive speed, view and flow mass at
frames 10, 30 and 60 of five presets, by its `stats`) and `POST_BANDS`
(the post-processed screen's masses for `Pissarides` with the bokeh on),
imported unchanged, at the corridors' size (90x160, `root_num=32`, seed
0, 60 frames). The last two presets and `POST_BANDS` are in
tests/test_torch_app_corridors_post.py.

The bands were recorded on the JAX package's xla backend, whose generic
draw the port does not have (ROADMAP item 4): the port's demo runs the
kernel draw, the JAX package's "pallas" backend. On that backend the JAX
demo itself leaves 22 of the 66 corridors at this size: every flow mass
of `Flow`, `Starlings`, `Kelp Forest` and `Pissarides`, `Flow`'s mean
speed at frame 30, `Pissarides`' speed and view mass from frame 30 on
and 5 of the 6 post masses (the fused draw's box line widths deposit
more flow than the generic draw's rows). So each test runs the same
demo on both (the JAX demo on "pallas", its kernels in interpret mode)
and holds the port:

- inside every band that the JAX demo's kernel path keeps, so the port
  leaves a corridor only where its reference does;
- within the bands' own relative width (x0.75 to x1.25, as the bands sit
  around their recorded run) of the JAX kernel path's statistic, for
  every statistic, kept band or not.

No band is widened; `Starlings`' image spawn finds no image here (the
corridors feed none), as in the JAX test.
"""

import pytest

from tendrils_tpu.app.demo import TendrilsDemo as JDemo
from tendrils_tpu_torch.app.demo import TendrilsDemo as TDemo
from test_preset_corridors import BANDS, stats

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

SIZE = dict(view_res=(90, 160), root_num=32, seed=0)
FRAMES = 60
MARGIN = (0.75, 1.25)  # the bands' own relative width


def _run(demo, preset, frames, read, bokeh=False):
    """Apply `preset`, render FRAMES frames, `read(demo)` at `frames`."""
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


def _hold(bands, port, ref, label):
    """The port inside every band the reference keeps, and within MARGIN
    of the reference everywhere."""
    kept = 0
    for f, band in bands.items():
        for k, (lo, hi) in band.items():
            got, want = port[f][k], ref[f][k]
            where = f"{label} frame {f}: {k}={got:.6g}"
            if lo <= want <= hi:
                kept += 1
                assert lo <= got <= hi, (
                    f"{where} outside [{lo:.6g}, {hi:.6g}], which the JAX "
                    f"kernel path keeps ({want:.6g})")
            assert MARGIN[0] * want <= got <= MARGIN[1] * want, (
                f"{where} not within x{MARGIN} of the JAX kernel path's "
                f"{want:.6g}")
    return kept


def check_preset(preset):
    """`preset`'s corridors: the port's demo against the JAX demo's kernel
    path, each run for FRAMES frames."""
    frames = set(BANDS[preset])
    port = _run(TDemo({"quality": 0}, device="cpu", **SIZE), preset, frames,
                stats)
    ref = _run(JDemo({"quality": 0}, splat_backend="pallas",
                     gather_backend="pallas", **SIZE), preset, frames, stats)
    assert _hold(BANDS[preset], port, ref, preset) > 0


# The presets split across this file and
# tests/test_torch_app_corridors_post.py, so that two test workers run
# the JAX reference demos side by side.
FIRST = list(BANDS)[:3]


@pytest.mark.parametrize("preset", FIRST)
def test_preset_corridor(preset):
    check_preset(preset)
