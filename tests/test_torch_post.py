"""The post stack (`ops/post.py`, `ops/filters.py`, `coords.uv_grid`)
against the JAX package's, against the exact transcriptions of the
reference's shaders (`tests/post_oracles.py`), and the interactive frame's
screen against the JAX facade's.

Tolerances, stated with each test: the elementwise helpers within an ulp
or two (rtol 1e-6); the blur stack within the JAX module's own cross-form
bound, 1e-4 (tests/test_post_oracle.py: matmul against cumsum); the level
LUT exact; `vignette_blur` and `bokeh` within the JAX module's bokeh
cross-form bounds, max 5e-3 and p99.9 2e-3 (its num/den division
amplifies f32 rounding where den is small); against the exact shaders the
bounds of tests/test_post_oracle.py.

The blur's grain jitters each pixel's level by the `glsl-random` hash,
`fract(sin(.) * 43758.5453)`, which turns the last bit of its argument
into a different draw: under `jit` XLA contracts the hash's multiply-add,
so the JAX reference runs under `jax.disable_jit()` (as
tests/test_torch_logic.py runs `spawn.ball`), and where XLA's `sin` and
torch's differ by an ulp across a wrap of the `fract` (a handful of pixels,
`_hash_wraps`) the max bound skips the pixel; the p99.9 bound does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from post_oracles import bokeh_exact, hash_blur_exact
from tendrils_tpu import engine as jengine
from tendrils_tpu.ops import coords as jcoords, filters as jfilters
from tendrils_tpu.ops import post as jpost, rand as jrand
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch.ops import coords as tcoords, filters as tfilters
from tendrils_tpu_torch.ops import post as tpost, rand as trand
from test_post_oracle import mkimg, rel
from torch_parity import _smooth, compare, port_engine, sim_arrays

SHAPES = [(61, 107), (192, 192)]


def _both(img):
    return jnp.asarray(img), torch.as_tensor(np.array(img))


def _hash_wraps(shape):
    """`bool[H, W]`: the pixels whose grain hash wraps differently in torch
    and in eager XLA (an ulp of `sin` across an integer of the `fract`);
    fewer than 1 in 1,000."""
    h, w = shape
    co = np.asarray(jcoords.uv_grid(shape)) * np.float32([w, h])
    with jax.disable_jit():
        a = np.asarray(jrand.glsl_random(jnp.asarray(co)))
    b = trand.glsl_random(torch.as_tensor(co)).numpy()
    wraps = np.abs(a - b) > 0.5
    assert wraps.mean() < 1e-3
    return wraps


def _within_cross_form(got, want, skip=None):
    """The JAX module's bokeh cross-form bounds: max 5e-3 (but at `skip`,
    `_hash_wraps`), p99.9 2e-3."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    kept = d if skip is None else d[:, ~skip]
    assert kept.max() < 5e-3, kept.max()
    assert float(np.quantile(d, 0.999)) < 2e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_uv_grid_matches_jax(shape):
    """Texel-centre UVs: the same f32 operations, bit for bit."""
    np.testing.assert_array_equal(tcoords.uv_grid(shape).numpy(),
                                  np.asarray(jcoords.uv_grid(shape)))


@pytest.mark.parametrize("curve", [None, 0.7, (0.2, 0.9), (0.0, 1.0, 1.0),
                                   (0.0, 1.0, 1.0, 1.0)])
def test_filters_match_jax(curve):
    """`bezier`, `vignette_amount`, `vignette` and `vignette_pass` over a
    uv grid, every curve length: rtol 1e-6 (an ulp of sqrt or a
    contracted multiply-add)."""
    juv, tuv = _both(np.array(jcoords.uv_grid((61, 107))))
    for mid, limit in (((0.5, 0.5), 0.4), ((0.3, 0.6), 0.8)):
        # Values near 0 of `1 - d / limit`: an ulp of 1 (1.2e-7) absolute.
        np.testing.assert_allclose(
            tfilters.vignette_amount(tuv, mid, limit).numpy(),
            np.asarray(jfilters.vignette_amount(juv, jnp.asarray(mid),
                                                limit)), rtol=1e-6,
            atol=2.5e-7)
        np.testing.assert_allclose(
            tfilters.vignette(tuv, mid, limit, curve).numpy(),
            np.asarray(jfilters.vignette(juv, jnp.asarray(mid), limit,
                                         curve)), rtol=1e-6, atol=2.5e-7)
    if curve is not None and np.ndim(curve):
        t = np.linspace(-0.5, 1.5, 37, dtype=np.float32)
        np.testing.assert_allclose(
            tfilters.bezier(curve, torch.as_tensor(t)).numpy(),
            np.asarray(jfilters.bezier(curve, jnp.asarray(t))), rtol=1e-6,
            atol=1e-7)
    pix = np.random.default_rng(0).uniform(0, 1, (3, 61, 107)).astype(
        np.float32)
    jp, tp = _both(pix)
    np.testing.assert_allclose(
        tfilters.vignette_pass(tuv, tp, (0.5, 0.5), 0.6, curve).numpy(),
        np.asarray(jfilters.vignette_pass(juv, jp, jnp.asarray([0.5, 0.5]),
                                          0.6, curve)), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_box_blur_matches_jax(shape):
    """The windowed box against the JAX cumsum box: values in [0, 1] over
    at most 192 texels a row, so the running sum's step is <= 2e-5."""
    img = mkimg(7, *shape)
    ji, ti = _both(img)
    for r in (0, 1, 3, 6):
        np.testing.assert_allclose(tpost.box_blur(ti, r).numpy(),
                                   np.asarray(jpost.box_blur(ji, r)),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("radii", [(2, 6, 16), (1, 3, 8)])
@pytest.mark.parametrize("shape", SHAPES)
def test_blur_stack_both_forms_match_jax(shape, radii):
    """The port's stack (the windowed boxes) against both of the JAX
    module's forms, its cumsum boxes and its banded matrices, within its
    own cross-form bound (1e-4)."""
    img = mkimg(3, *shape)
    ji, ti = _both(img)
    got = tpost.blur_stack(ti, radii)
    for jm in (None, jpost.blur_stack_matrices(shape, radii)):
        jref = jpost.blur_stack(ji, radii, mats=jm)
        assert len(got) == len(jref) == len(radii) + 1
        for g, r in zip(got, jref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("kind,radii", [("disc", (1, 3, 8)),
                                        ("bokeh", (2, 6, 16)),
                                        ("disc", (2, 6, 16))])
def test_level_lut_is_the_jax_modules(kind, radii):
    """The offline LUT, copied: equal to the JAX module's bit for bit."""
    assert tpost._level_lut(radii, kind) == jpost._level_lut(radii, kind)


def test_interp_matches_jnp_interp():
    """`post.interp` against `jnp.interp` on the LUT's knots, points
    inside, on and beyond them: within an ulp (XLA may contract the
    multiply-add)."""
    s, lv = tpost._level_lut((2, 6, 16), "bokeh")
    x = np.concatenate([np.linspace(-3.0, 20.0, 501), np.asarray(s)]).astype(
        np.float32)
    got = tpost.interp(torch.as_tensor(x), torch.tensor(s), torch.tensor(lv))
    want = jnp.interp(jnp.asarray(x), jnp.asarray(s), jnp.asarray(lv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("radius,limit,grain", [(3.0, 0.5, 0.75),
                                                (9.0, 0.5, 0.0),
                                                (5.0, 0.4, 0.75)])
@pytest.mark.parametrize("shape", SHAPES)
def test_vignette_blur_matches_jax(shape, radius, limit, grain):
    """`vignette_blur` against the JAX function in both of its stack
    forms (eager) within the cross-form bounds; alpha passes through."""
    img = mkimg(5, *shape)
    ji, ti = _both(img)
    got = tpost.vignette_blur(ti, radius, limit, grain=grain)
    assert torch.equal(got[3], ti[3])
    skip = _hash_wraps(shape) if grain else None
    for jm in (None, jpost.blur_stack_matrices(shape, (1, 3, 8))):
        with jax.disable_jit():
            want = np.asarray(jpost.vignette_blur(ji, radius, limit,
                                                  grain=grain, mats=jm))
        _within_cross_form(got.numpy(), want, skip)


@pytest.mark.parametrize("radius,amount", [(1.0, 20.0), (3.0, 40.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_bokeh_matches_jax(shape, radius, amount):
    """`bokeh` against the JAX function in both of its stack forms,
    within the cross-form bounds; alpha passes through."""
    img = mkimg(9, *shape)
    ji, ti = _both(img)
    got = tpost.bokeh(ti, radius, amount)
    assert torch.equal(got[3], ti[3])
    for jm in (None, jpost.blur_stack_matrices(shape, (2, 6, 16))):
        want = jpost.bokeh(ji, radius, amount, mats=jm)
        _within_cross_form(got.numpy(), want)


# --- against the exact shaders (tests/test_post_oracle.py's bounds) --------


@pytest.mark.parametrize("radius,limit,bound", [
    (3, 0.5, 0.06), (5, 0.4, 0.065), (9, 0.5, 0.09), (6, 0.8, 0.065)])
def test_blur_close_to_exact_shader(radius, limit, bound):
    img = mkimg(3 if radius in (3, 5) else 5)
    exact = hash_blur_exact(img, radius, limit, time=7.0)
    base = rel(img, exact)
    got = tpost.vignette_blur(torch.as_tensor(img), float(radius),
                              float(limit)).numpy()
    err = rel(got, exact)
    assert err < bound, err
    assert err < base / 2.5, (err, base)


@pytest.mark.parametrize("rad,amt,bound", [(1, 20, 0.12), (2, 20, 0.18)])
def test_bokeh_close_to_exact_shader(rad, amt, bound):
    img = mkimg(3)
    exact = bokeh_exact(img, rad, amt)
    base = rel(img, exact)
    got = tpost.bokeh(torch.as_tensor(img), float(rad), float(amt)).numpy()
    err = rel(got, exact)
    assert err < bound, err
    assert err < base / 4, (err, base)


def test_blur_centre_untouched():
    img = mkimg(3)
    got = tpost.vignette_blur(torch.as_tensor(img), 5.0, 0.4).numpy()
    c = slice(90, 102)
    assert np.abs(got[:3, c, c] - img[:3, c, c]).max() < 5e-3


# --- the interactive frame's screen ------------------------------------------

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")


@pytest.fixture(scope="module")
def start():
    """The JAX engine spawned and run 3 frames (a trail in the view)."""
    eng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    for _ in range(3):
        eng.frame()
    return eng.config, jax.tree_util.tree_map(jnp.array, eng.sim), \
        eng.timer.time


@pytest.mark.parametrize("post", [dict(blur=(5.0, 0.4)),
                                  dict(bokeh=(3.0, 40.0)),
                                  dict(blur=(5.0, 0.4), bokeh=(2.0, 20.0))],
                         ids=["blur", "bokeh", "blur+bokeh"])
def test_step_draw_io_screen_matches_jax(start, post):
    """`step_draw_io(blur=..., bokeh=...)` returns the screen: against the
    JAX facade's (which passes its matrices) with the frames' grid
    tolerance (`torch_parity`: 1-px smoothed rtol 5e-2 / atol 2e-2, the
    splats' bf16 against f32), and against the JAX post run (eagerly) on
    the port's own view within the cross-form bounds; the state as
    `compare` holds it."""
    cfg, sim0, t0 = start
    jeng = jengine.Tendrils(cfg)
    jeng.setup()
    jeng.sim = jax.tree_util.tree_map(jnp.array, sim0)
    jeng.timer.time = t0
    teng = port_engine(cfg, sim_arrays(sim0), t0)
    jscreen = np.asarray(jeng.step_draw_io(**post))
    tscreen = teng.step_draw_io(**post)
    h, w = cfg.view_res
    assert tscreen.shape == (4, h, w) and torch.isfinite(tscreen).all()
    compare(teng.sim, sim_arrays(jeng.sim))
    np.testing.assert_allclose(_smooth(tscreen.numpy()), _smooth(jscreen),
                               rtol=5e-2, atol=2e-2)
    view = jnp.asarray(teng.sim.view[0].numpy())
    with jax.disable_jit():
        if "blur" in post:
            view = jpost.vignette_blur(view, *post["blur"],
                                       mats=jeng._blur_mats((1, 3, 8)))
        if "bokeh" in post:
            view = jpost.bokeh(view, *post["bokeh"],
                               mats=jeng._blur_mats((2, 6, 16)))
    _within_cross_form(tscreen.numpy(), np.asarray(view),
                       _hash_wraps((h, w)) if "blur" in post else None)


def test_step_draw_io_without_post_returns_none(start):
    teng = port_engine(start[0], sim_arrays(start[1]), start[2])
    assert teng.step_draw_io() is None


@pytest.mark.parametrize("name", ["blur", "bokeh"])
def test_facade_screen_is_the_windowed_boxes_form(start, name):
    """The facade's post stage runs the blur stack's windowed boxes: its
    screen is `vignette_blur` / `bokeh` on the frame's view, bit for bit,
    and within the cross-form bounds of the JAX module's banded-matrix
    form (eager) on the same view."""
    fn, jfn, args, radii = {
        "blur": (tpost.vignette_blur, jpost.vignette_blur, (5.0, 0.4),
                 (1, 3, 8)),
        "bokeh": (tpost.bokeh, jpost.bokeh, (3.0, 40.0), (2, 6, 16))}[name]
    teng = port_engine(start[0], sim_arrays(start[1]), start[2])
    screen = teng.step_draw_io(**{name: args})
    view = teng.sim.view[0]
    assert torch.equal(screen, fn(view, *args))
    h, w = start[0].view_res
    mats = jpost.blur_stack_matrices((h, w), radii)
    with jax.disable_jit():
        want = jfn(jnp.asarray(view.numpy()), *args, mats=mats)
    _within_cross_form(screen.numpy(), np.asarray(want),
                       _hash_wraps((h, w)) if name == "blur" else None)
