"""The port's last single-device host modules against the JAX package's:
`native` (the C++ line-mesh library, built with g++ into
build/tendrils_tpu_torch/) with `geom`, `utils.fp`, `utils.profiling`,
`ops.physics` and `ops.glsl_utils`, on the same seeded inputs.

`geom`'s ribbons are also held to tests/gl_line_oracle.py, the GL wide-line
rule: an axis-aligned path's strip of half-width `rad` covers the pixel
centres that GL's `lineWidth = 2 rad` pen lights.

Tolerances: the numpy path of `geom` and the plain-Python modules equal
to the JAX package's; the C++ path within 1e-5 of the numpy one
(tests/test_native.py's); the torch ops within rtol 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gl_line_oracle import gl_lines_exact
from tendrils_tpu import geom as jgeom, native as jnative
from tendrils_tpu.ops import glsl_utils as jg, physics as jphysics
from tendrils_tpu.utils import fp as jfp, profiling as jprofiling
from tendrils_tpu_torch import geom, native
from tendrils_tpu_torch.audio import analyse
from tendrils_tpu_torch.ops import glsl_utils as tg, physics
from tendrils_tpu_torch.utils import fp, profiling


@pytest.fixture
def numpy_geom(monkeypatch):
    """`geom` on its numpy path, as on a host without g++."""
    monkeypatch.setattr(geom, "_native", False)


def test_native_builds_outside_the_source_tree():
    lib = native.load()
    assert lib is native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "tendrils_tpu_torch")


@pytest.mark.parametrize("closed", [False, True])
def test_polyline_normals_match_jax(closed, numpy_geom):
    """The numpy path equal to the JAX module's (which takes numpy), the
    C++ path within 1e-5 of it; `paths` counts which ran."""
    path = np.random.default_rng(0).uniform(-1, 1, (64, 2))
    want = jgeom.polyline_normals(path, closed)
    geom.paths.clear()
    got = geom.polyline_normals(path, closed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    nat = native.polyline_normals(path, closed)
    for a, b in zip(nat, want):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert geom.paths == {"numpy": 1}


def test_geom_takes_the_native_path(monkeypatch):
    monkeypatch.setattr(geom, "_native", None)
    geom.paths.clear()
    path = [[0, 0], [1, 0], [1, 1], [3, 2]]
    n, m = geom.polyline_normals(path)
    assert geom.paths == {"native": 1}
    jn, jm = jgeom.polyline_normals(path)
    np.testing.assert_allclose(n, jn, atol=1e-5)
    np.testing.assert_allclose(m, jm, atol=1e-5)


@pytest.mark.parametrize("closed", [False, True])
def test_line_vertices_match_jax(closed, numpy_geom):
    path = np.random.default_rng(1).uniform(0, 10, (7, 2)).tolist()
    seen = []
    lines = [mod.Line({"rad": 0.3}, path=path, closed=closed)
             for mod in (geom, jgeom)]
    for line in lines:
        line.update(lambda v, i, a, s: seen.append(i["data"]))
    assert seen[:len(seen) // 2] == seen[len(seen) // 2:]
    for key in ("position", "normal", "miter"):
        np.testing.assert_array_equal(lines[0].attributes[key],
                                      lines[1].attributes[key])
    np.testing.assert_array_equal(lines[0].vertices(0.7),
                                  lines[1].vertices(0.7))


@pytest.mark.parametrize("axis,rad", [(0, 1.5), (0, 2.25), (1, 2.0)])
def test_ribbon_covers_the_gl_pen(axis, rad):
    """A straight path along x (axis 0) or y (axis 1), in pixels: the
    pixel centres inside its strip (half-open, as GL's fragment rule) are
    the pixels GL's pen of width 2 rad lights (tests/gl_line_oracle.py)."""
    h, w = 24, 40
    pts = np.asarray([[6.3, 11.7], [17.0, 11.7], [29.6, 11.7]])
    if axis:
        pts = np.stack([pts[:, 1] - 2.0, pts[:, 0] - 4.0], axis=-1)
    line = geom.Line({"rad": rad}, path=pts.tolist()).update()
    verts = line.vertices()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    ys, xs = np.mgrid[:h, :w] + 0.5
    strip = (xs >= lo[0]) & (xs < hi[0]) & (ys >= lo[1]) & (ys < hi[1])
    _, cover = gl_lines_exact(np.zeros((1, h, w), np.float32),
                              pts[:-1].astype(np.float32),
                              pts[1:].astype(np.float32),
                              np.ones((1, 2), np.float32),
                              np.full(2, 0.5, np.float32), 2 * rad)
    assert strip.sum() > 0
    np.testing.assert_array_equal(strip, cover > 0)


def test_fill_ribbon_and_log_rates_match_jax():
    rng = np.random.default_rng(2)
    path = rng.uniform(-1, 1, (20, 2))
    times = np.cumsum(rng.uniform(0.5, 20, 20))
    for a, b in zip(native.fill_ribbon(path, times, 0.4, 2.0),
                    jnative.fill_ribbon(path, times, 0.4, 2.0)):
        np.testing.assert_array_equal(a, b)
    last = rng.uniform(0, 1, 64).astype(np.float32)
    cur = rng.uniform(0, 1, 64).astype(np.float32)
    got = native.log_rates(last, cur, 2.0)
    np.testing.assert_array_equal(got, jnative.log_rates(last, cur, 2.0))
    np.testing.assert_allclose(got, analyse.log_rates(last, cur, 2.0),
                               rtol=1e-6)


def test_fp_matches_jax():
    src = {"a": 1, "b": 2, "c": 3}
    for mod_a, mod_b in ((fp, jfp),):
        assert mod_a.map_obj(lambda v, k: v * 2, src) == mod_b.map_obj(
            lambda v, k: v * 2, src)
        assert mod_a.map_obj(lambda v, k: v + k, [1, 2], [0]) == \
            mod_b.map_obj(lambda v, k: v + k, [1, 2], [0])
        assert mod_a.map_list(lambda v, k: -v, [1, 2], [0, 0]) == [-1, -2]
        assert mod_a.reduce_obj(lambda a, v, k: (a or 0) + v, src) == 6
        assert mod_a.filter_obj(lambda v, k: v > 1, src) == \
            mod_b.filter_obj(lambda v, k: v > 1, src)
        seen = []
        mod_a.each(lambda v, k: seen.append((k, v)), src)
        assert seen == list((k, v) for k, v in src.items())
        f = mod_a.compose(lambda x: x + 1, lambda x: x * 2)
        assert f(3) == mod_b.compose(lambda x: x + 1, lambda x: x * 2)(3)
        add3 = mod_a.curry(lambda a, b, c: a + b + c)
        assert add3(1)(2)(3) == add3(1, 2)(3) == 6


def test_frame_profiler_matches_jax(tmp_path):
    """The same sections on both profilers give the same summary keys and
    counts; `sync` waits on nothing for CPU tensors and finds a tensor
    inside structures; `trace` writes a Chrome trace."""
    profs = (profiling.FrameProfiler(history=4),
             jprofiling.FrameProfiler(history=4))
    results = (torch.ones(3), jnp.ones(3))
    for prof, res in zip(profs, results):
        for _ in range(6):
            prof.begin_frame()
            with prof.section("step", result=res):
                pass
            with prof.section("draw") as box:
                box["result"] = {"x": [res]}
            prof.end_frame()
    a, b = (p.summary() for p in profs)
    assert list(a) == list(b) == ["draw", "frame", "step"]
    assert [v["count"] for v in a.values()] == [4, 4, 4]
    assert profs[0].counts == profs[1].counts
    assert len(profs[0].report().splitlines()) == 3
    t = torch.zeros(2)
    assert profiling.sync(t) is t
    assert profiling._first_tensor(({"k": [None, t]},)) is t
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "tr") and events


def test_physics_matches_jax():
    rng = np.random.default_rng(3)
    a, p0, p1, p2 = (rng.uniform(-1, 1, (2, 16)).astype(np.float32)
                     for _ in range(4))
    t = [torch.as_tensor(v) for v in (a, p0, p1, p2)]
    j = [jnp.asarray(v) for v in (a, p0, p1, p2)]
    for name, args in (("euler", (0, 1, 0.5)), ("euler_dy_dt", (1, 2, 0.5)),
                       ("verlet", (0, 1, 2, 0.5)),
                       ("verlet_dy_dt", (1, 2, 3, 0.5, 0.25))):
        pos = [i for i in args if isinstance(i, int)]
        rest = [i for i in args if not isinstance(i, int)]
        got = getattr(physics, name)(*[t[i] for i in pos], *rest)
        want = getattr(jphysics, name)(*[j[i] for i in pos], *rest)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=name)
    assert physics.euler(2.0, 1.0, 0.5) == jphysics.euler(2.0, 1.0, 0.5)


def test_glsl_utils_match_jax():
    rng = np.random.default_rng(4)
    v = rng.uniform(-2, 2, (10, 2)).astype(np.float32)
    m = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    box = np.float32([-0.5, -0.5, 1.0, 1.0])
    rgb = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    start, end = v[:3], v[3:6]
    cases = [("length2", (v,)), ("nilish", (v * 1e-6,)),
             ("nilish", (v[:, 0] * 1e-5,)), ("perp", (v,)),
             ("transform", (m, v)), ("point_in_box", (v, box)),
             ("line_sdf", (v[6:9], start, end, 0.25)),
             ("rgb_to_hsv", (rgb,)), ("hsv_to_rgb", (rgb,))]
    for name, args in cases:
        got = getattr(tg, name)(*[torch.as_tensor(x) if isinstance(
            x, np.ndarray) else x for x in args])
        want = getattr(jg, name)(*[jnp.asarray(x) if isinstance(
            x, np.ndarray) else x for x in args])
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tg.perp(v, anti=True).numpy(),
                                  np.asarray(jg.perp(jnp.asarray(v), True)))
    back = tg.hsv_to_rgb(tg.rgb_to_hsv(torch.as_tensor(rgb)))
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
