"""The port's spawn ops and spawner objects (`ops/spawn.py`,
`spawners.py`) against the JAX package's, on the same seeded inputs.

The JAX spawn functions run under `jax.disable_jit()`: jitted XLA on the
CPU contracts multiply-adds into FMAs, which moves the `glsl_random` hash
(`fract(sin(.) * 43758.5453)` keeps 8 bits, so one ulp of its argument
or of `sin` is 1/256 of a draw). XLA's `sin` and torch's also differ in
the last bit on a few per cent of arguments, and there the hash gives a
different, equally valid draw. So each comparison first evaluates both
packages' hashes on every input the spawn hashes (`_hash_mask`),
requires each hash to agree bit for bit on most rows (MIN_AGREE), and
holds the rows whose hashes all agree at RTOL/ATOL; a best-of-6 spawn
hashes up to 30 times a row, so those are a third to a half of the rows,
and at least MIN_ROWS of them are compared. The threefry streams of `ball_random` and
`shuffle_triangles` have no torch counterpart (a `torch.Generator`
instead): those are held by their bounds and moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, spawners as jspawners
from tendrils_tpu.ops import rand as jrand, spawn as jspawn
from tendrils_tpu_torch import spawners as tspawners
from tendrils_tpu_torch.ops import rand as trand, sample as tsample
from tendrils_tpu_torch.ops import spawn as tspawn
from torch_parity import port_engine, sim_arrays

# sin, cos, exp and sqrt differ in the last bit between XLA and torch.
RTOL, ATOL = 1e-5, 1e-6
# The least share of rows on which each hash agrees (a few per cent of
# sin's arguments differ in the last bit), and the fewest rows compared.
MIN_AGREE = 0.9
MIN_ROWS = 256
ROOT = 32
VIEW = (32, 64)
TIME = np.float32(1234.5)

CFG = dict(root_num=ROOT, view_res=VIEW, flow_samples=2, flow_rows=1,
           view_samples=2)


def _uv(root=ROOT):
    """Row-wise data-texture UVs `f32[N, 2]` of a permuted row order."""
    idx = np.random.default_rng(7).permutation(root * root)
    ix, iy = idx % root, idx // root
    return np.stack([(ix + 0.5) / root, (iy + 0.5) / root],
                    axis=-1).astype(np.float32)


def _state(n, seed=1):
    """A particle state after a few frames: positions in the view, speeds
    within 0.01, a tenth of the rows inert."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-1, 1, (2, n)),
                        rng.uniform(-0.01, 0.01, (2, n))]).astype(np.float32)
    p[:2, rng.random(n) < 0.1] = -1e6
    return p


def _image(shape=(4, 40, 48), seed=2):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _flow_grid(shape=(4, 32, 64), seed=3):
    """A flow grid: velocities, a time stamp near TIME, a weight."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-0.01, 0.01, shape).astype(np.float32)
    g[2] = rng.uniform(TIME - 200, TIME, shape[1:])
    g[3] = rng.uniform(0, 1, shape[1:])
    return g


def _agree(inputs, jax_inputs=None):
    """Rows whose `glsl_random` agrees bit for bit on every `f32[N, 2]`
    input in `inputs` (torch tensors). `jax_inputs`, where given, are the
    JAX side's own inputs (numpy): a row agrees only where they equal the
    port's too."""
    same = None
    for k, co in enumerate(inputs):
        c = co.numpy()
        cj = c if jax_inputs is None else jax_inputs[k]
        j = np.asarray(jrand.glsl_random(jnp.asarray(cj)))
        t = trand.glsl_random(co).numpy()
        ok = (j == t) & (cj == c).all(axis=-1)
        assert ok.mean() > MIN_AGREE, ok.mean()
        if jax_inputs is None:
            d = np.abs(j - t)
            # An ulp, amplified; across the fract's wrap, 1 less that.
            assert np.minimum(d, 1 - d).max() <= 2 / 256
        same = ok if same is None else same & ok
    return same


def _jitter_inputs(uv, time):
    return [uv - 1.2345 + time * 0.001, uv + 1.2345 + time * 0.001]


def _hash_mask(conf, prev, uv, time, data):
    """The rows where every hash of the pixel spawn `conf` agrees: the
    jitter of `spawn_to_pos` and, for the best-of-N modes, each sample's
    two UV hashes (seeded from the state the spawn starts from) and the
    brightest apply's direction hash. The inputs follow the port's
    arithmetic, the same f32 operations as the JAX function's."""
    t = torch.as_tensor
    prev, uv, data = t(prev), t(uv), t(data)
    time = t(np.asarray(time, np.float32))
    if conf["mode"] == "direct":
        return _agree(_jitter_inputs(uv, time))
    base = prev.T + torch.cat([uv, uv], dim=-1) + (1.2345 + time * 0.001)
    inputs = []
    for k in range(conf["samples"]):
        seed = base + float(k)
        inputs += [seed[:, :2], seed[:, 2:]]
        suv = torch.stack([trand.mod(trand.glsl_random(seed[:, :2]), 1.0),
                           trand.mod(trand.glsl_random(seed[:, 2:]), 1.0)],
                          dim=-1)
        inputs += _jitter_inputs(suv, time)
        if conf["apply"] == "brightest":
            pix = tsample.sample_uv(data, suv)
            inputs.append(suv * torch.sum(pix[:2] * pix[2:], dim=0)[:, None])
    return _agree(inputs)


def _close_on(mask, got, want):
    assert mask.sum() >= MIN_ROWS, mask.sum()
    np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=RTOL,
                               atol=ATOL)


# --- the plugins -----------------------------------------------------------


def _pixels(n, seed=4):
    """A candidate pixel `f32[4, N]` with saturated, grey and black rows
    (rgb_to_hsv's branches), and the uv and pos of the plugins."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 1, (4, n)).astype(np.float32)
    px[:3, ::5] = px[0, ::5]  # grey: d = 0
    px[:3, 1::7] = 0.0  # black
    px[1, 2::9] = px[0, 2::9]  # r == g ties
    px[2, 3::11] = px[1, 3::11] + 0.25  # blue max
    px[2, 8::13] = TIME - rng.uniform(0, 400, px[2, 8::13].shape)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return px, uv, pos


@pytest.mark.parametrize("vignette", [False, True])
@pytest.mark.parametrize("name", ["color", "brightest", "flow", "particles",
                                  "simple", "identity"])
def test_apply_plugins_match_jax(name, vignette):
    """Each `apply_*` (and behind `with_vignette`) on the same pixels; the
    brightest apply's hash masked."""
    px, uv, pos = _pixels(1024)
    kw = dict(time=TIME, decay=np.float32(0.005))
    jfn = jspawners._APPLIES[name]
    tfn = tspawners._APPLIES[name]
    if vignette:
        jfn, tfn = jspawn.with_vignette(jfn), tspawn.with_vignette(tfn)
    with jax.disable_jit():
        want = np.asarray(jfn(jnp.asarray(uv), jnp.asarray(pos),
                              jnp.asarray(px), time=jnp.float32(TIME),
                              decay=jnp.float32(kw["decay"])))
    t = torch.as_tensor
    got = tfn(t(uv), t(pos), t(px), time=t(np.asarray(TIME)),
              decay=t(np.asarray(kw["decay"]))).numpy()
    assert got.shape == want.shape == (4, 1024)
    mask = np.ones(1024, bool)
    if name == "brightest":
        from tendrils_tpu.ops.filters import vignette as jvig
        from tendrils_tpu_torch.ops.filters import vignette as tvig
        pm, pj = t(px), px
        if vignette:
            curve = (0.1, 1.0, 1.0)
            pm = pm * tvig(t(uv), (0.5, 0.5), 0.6, curve)[None]
            with jax.disable_jit():
                pj = px * np.asarray(jvig(jnp.asarray(uv), jnp.asarray(
                    [0.5, 0.5], jnp.float32), 0.6, jnp.asarray(
                        curve, jnp.float32)))[None]
        mask = _agree([t(uv) * torch.sum(pm[:2] * pm[2:], dim=0)[:, None]],
                      [uv * np.sum(pj[:2] * pj[2:], axis=0)[:, None]])
    _close_on(mask, got, want)


@pytest.mark.parametrize("name", ["test_particles", "test_brightest",
                                  "test_simple", "luma"])
def test_scorers_match_jax(name):
    """The best-sample scorers and `luma`: exact arithmetic."""
    px = _pixels(1024)[0]
    want = np.asarray(getattr(jspawn, name)(jnp.asarray(px)))
    got = getattr(tspawn, name)(torch.as_tensor(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rgb_to_hsv_matches_jax():
    """Grey, black, tied and saturated pixels through every branch."""
    px = _pixels(1024)[0]
    with jax.disable_jit():
        want = [np.asarray(v) for v in jspawn.rgb_to_hsv(
            *(jnp.asarray(c) for c in px[:3]))]
    got = tspawn.rgb_to_hsv(*(torch.as_tensor(c) for c in px[:3]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    grey = (px[0] == px[1]) & (px[1] == px[2])
    assert grey.any() and (want[0][grey] == 0).all()  # the d < eps branch


def test_uv_to_pos_matches_jax():
    from tendrils_tpu.ops import coords as jcoords
    from tendrils_tpu_torch.ops import coords as tcoords
    uv = _uv()
    np.testing.assert_array_equal(
        tcoords.uv_to_pos(torch.as_tensor(uv)).numpy(),
        np.asarray(jcoords.uv_to_pos(jnp.asarray(uv))))


def test_spawn_to_pos_matches_jax():
    """Jitter, Y flip, size and a matrix with the demo's X flip and a
    shift; the two jitter hashes masked."""
    uv = _uv()
    m = np.eye(3, dtype=np.float32)
    m[0, 0], m[0, 2], m[1, 2] = -1.0, 0.1, -0.05
    size = np.float32([0.75, 1.25])
    jit = np.float32([2.0 / VIEW[1], 2.0 / VIEW[0]])
    with jax.disable_jit():
        want = np.asarray(jspawn.spawn_to_pos(
            jnp.asarray(uv), jnp.asarray(m), jnp.asarray(size),
            jnp.asarray(jit), jnp.float32(TIME)))
    t = torch.as_tensor
    time = t(np.asarray(TIME))
    got = tspawn.spawn_to_pos(t(uv), t(m), t(size), t(jit), time).numpy()
    mask = _agree(_jitter_inputs(t(uv), time))
    _close_on(mask, got.T, want.T)


# --- the pixel spawns --------------------------------------------------------


def _shader_inputs(shader):
    """Spawn data for a shader as the demo feeds it: the flow grid for
    flow-sample, a particle buffer for data-sample, else an image."""
    n = ROOT * ROOT
    if shader == "flow-sample":
        return _flow_grid()
    if shader == "data-sample":
        return _state(n, seed=5).reshape(4, ROOT, ROOT)
    return _image()


def _spawn_kwargs(conf, data, lib):
    """The keywords `PixelSpawner._op` passes, in `lib`'s types."""
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = -1.0  # the demo's X flip
    vals = dict(speed=np.float32(0.3), spawn_matrix=m,
                spawn_size=np.float32([1.0, 1.0]),
                jitter=np.float32([2.0 / VIEW[1], 2.0 / VIEW[0]]),
                time=TIME, decay=np.float32(0.005),
                bias=np.float32(1.2))
    conv = jnp.asarray if lib is jspawn else torch.as_tensor
    kw = {k: conv(np.asarray(v)) for k, v in vals.items()}
    kw["speed"] = float(vals["speed"]) if lib is tspawn else kw["speed"]
    kw["bias"] = float(vals["bias"]) if lib is tspawn else kw["bias"]
    apply_fn = (jspawners if lib is jspawn else tspawners)._APPLIES[
        conf["apply"]]
    if conf.get("vignette"):
        apply_fn = lib.with_vignette(apply_fn)
    kw["apply_fn"] = apply_fn
    if conf["apply"] != "flow":
        del kw["decay"]
    if conf["mode"] == "direct":
        del kw["bias"]
        return lib.pixels_direct, kw
    kw["test_fn"] = (jspawners if lib is jspawn else tspawners)._TESTS[
        conf["test"]]
    kw["samples"] = conf["samples"]
    return lib.pixels_best_sample, kw


@pytest.mark.parametrize("shader", sorted(tspawners._PIXEL_SHADERS))
def test_pixel_shaders_match_jax(shader):
    """`pixels_direct` and `pixels_best_sample` in each configuration of
    `_PIXEL_SHADERS`, hashes masked."""
    assert tspawners._PIXEL_SHADERS == jspawners._PIXEL_SHADERS
    conf = tspawners._PIXEL_SHADERS[shader]
    n = ROOT * ROOT
    prev, uv, data = _state(n), _uv(), _shader_inputs(shader)
    fn, kw = _spawn_kwargs(conf, data, jspawn)
    with jax.disable_jit():
        want = np.asarray(fn(jnp.asarray(prev), jnp.asarray(data),
                             jnp.asarray(uv), **kw))
    fn, kw = _spawn_kwargs(conf, data, tspawn)
    t = torch.as_tensor
    got = fn(t(prev), t(data), t(uv), **kw).numpy()
    assert got.shape == want.shape == (4, n)
    _close_on(_hash_mask(conf, prev, uv, TIME, data), got, want)
    if conf["mode"] == "best":
        # Rows switch to a sampled candidate (all of them for the fast
        # colour candidates; a few for data- and flow-sample, whose
        # candidates are as slow as the state).
        assert (got != prev).any(axis=0).any()


# --- the geometry spawner's fans ---------------------------------------------


def test_rasterize_triangles_matches_jax():
    """The JAX fan (shuffled from a threefry key, passed as numpy) on the
    geometry spawner's 0.2x grid of a 64x128 view and on a non-square
    view: equal texel for texel (both run op by op, so the edge functions
    round alike)."""
    for seed, (h, w) in ((0, (12, 25)), (3, (16, 16)), (5, (9, 40))):
        tris = np.array(jspawn.shuffle_triangles(jax.random.PRNGKey(seed),
                                                   count=4))
        vs = np.float32(max(h, w)) / np.asarray([w, h], np.float32)
        with jax.disable_jit():
            want = np.asarray(jspawn.rasterize_triangles(
                jnp.asarray(tris), (h, w), jnp.asarray(vs),
                (1.0, 0.5, 0.25, 1.0)))
        got = tspawn.rasterize_triangles(
            torch.as_tensor(tris), (h, w), torch.as_tensor(vs),
            (1.0, 0.5, 0.25, 1.0)).numpy()
        assert want[3].sum() > 0
        np.testing.assert_array_equal(got, want)


def test_shuffle_triangles_bounds():
    """The port's fans from a `torch.Generator`: a vertex at the origin,
    the others within the radii, arcs of the configured spread; another
    draw gives another fan, the same seed the same fan."""
    g = torch.Generator().manual_seed(0)
    tris = tspawn.shuffle_triangles(g, count=200)
    assert tris.shape == (200, 3, 2)
    assert (tris[:, 0] == 0).all()
    r = torch.linalg.norm(tris[:, 1:], dim=-1)
    assert (r >= 0.25 - 1e-6).all() and (r <= 1.55 + 1e-6).all()
    assert abs(r.mean().item() - 0.9) < 0.05  # uniform in [0.25, 1.55]
    a1 = torch.atan2(tris[:, 1, 1], tris[:, 1, 0])
    a2 = torch.atan2(tris[:, 2, 1], tris[:, 2, 0])
    half = torch.remainder(a2 - a1, 2 * np.pi) / 2  # the arc
    lo, hi = 2 * np.pi * 1e-2, 2 * np.pi * (1e-2 + 3e-2 + 0.25)
    assert (half >= lo - 1e-4).all() and (half <= hi + 1e-4).all()
    obtuse = (half > 2 * np.pi * (1e-2 + 3e-2) + 1e-4).float().mean()
    assert 0.4 < obtuse.item() < 0.6  # obtuse rate 0.5
    again = tspawn.shuffle_triangles(torch.Generator().manual_seed(0),
                                     count=200)
    assert torch.equal(tris, again)
    assert not torch.equal(tris, tspawn.shuffle_triangles(g, count=200))


def test_ball_random_bounds_and_moments():
    """`ball_random` from `Tendrils.generator`: inside the disc and the
    speed, radius uniform on [0, radius] (mean radius / 2), directions
    uniform (mean position near 0); successive calls differ."""
    from tendrils_tpu_torch import engine as tengine
    t = tengine.Tendrils(tengine.EngineConfig(**CFG), seed=3,
                         device="cpu").setup()
    p = tspawn.ball_random(t.sim.particles, t.generator, 0.4, 0.01)
    r = torch.hypot(p[0], p[1])
    s = torch.hypot(p[2], p[3])
    assert (r <= 0.4 + 1e-6).all() and (s <= 0.01 + 1e-8).all()
    assert abs(r.mean().item() - 0.2) < 0.02
    assert abs(s.mean().item() - 0.005) < 0.0005
    assert p[:2].mean(dim=1).abs().max().item() < 0.03
    q = tspawn.ball_random(t.sim.particles, t.generator, 0.4, 0.01)
    assert not torch.equal(p, q)
    # The facade's seed fixes the stream.
    u = tengine.Tendrils(tengine.EngineConfig(**CFG), seed=3,
                         device="cpu").setup()
    assert torch.equal(
        p, tspawn.ball_random(u.sim.particles, u.generator, 0.4, 0.01))


# --- the spawner objects through the facades --------------------------------


@pytest.fixture(scope="module")
def facades():
    """A JAX facade with a seeded state (no frame run: the spawns read the
    state and the timer only), and the port's on the CPU from it."""
    jeng = jengine.Tendrils(jengine.EngineConfig(**CFG))
    jeng.setup()
    n = ROOT * ROOT
    jeng.sim = dataclasses.replace(
        jeng.sim, particles=jnp.asarray(_state(n, 1)),
        previous=jnp.asarray(_state(n, 2)),
        idx=jnp.asarray(np.random.default_rng(7).permutation(n),
                        jnp.int32), flow=jnp.asarray(_flow_grid()))
    jeng.timer.time = float(TIME)
    return jeng, sim_arrays(jeng.sim)


def _pair(facades):
    """Both facades at the fixture's state and time."""
    jeng, arrays = facades
    jeng.sim = dataclasses.replace(jeng.sim, **{
        k: jnp.asarray(arrays[k])
        for k in ("particles", "previous", "targets", "idx", "flow")})
    jeng.timer.time = float(TIME)
    jeng._targets_live = False
    return jeng, port_engine(jeng.config, arrays, float(TIME))


def _make(cls, shader, data, **kw):
    """A JAX spawner and the port's, alike."""
    objs = []
    for mod in (jspawners, tspawners):
        sp = (getattr(mod, cls)(**kw) if cls == "GeometrySpawner"
              else getattr(mod, cls)(shader=shader, **kw))
        if data is not None:
            sp.set_pixels(data)
        objs.append(sp)
    return objs


@pytest.mark.parametrize("case", ["direct", "best-sample", "flow-sample",
                                  "data-sample", "geometry"])
@pytest.mark.parametrize("target", [None, "targets"])
def test_spawner_objects_match_jax(facades, case, target):
    """`PixelSpawner` in the demo's shaders (camera image, flow grid,
    particle buffer) and `GeometrySpawner` (the JAX fan handed to the
    port's) through each facade's `spawn`, into the particles and into the
    targets: the same rows (hashes masked); a target spawn reads
    `previous`, leaves the particles and `previous` bit-equal and marks
    the targets live; a particle spawn rotates the ping-pong."""
    jeng, teng = _pair(facades)
    if case == "flow-sample":
        js, ts = _make("PixelSpawner", case, None)
        js.set_pixels(jeng.sim.flow)
        ts.set_pixels(teng.sim.flow)
    elif case == "data-sample":
        js, ts = _make("PixelSpawner", case, None)
        js.set_pixels(jeng.sim.particles.reshape(4, ROOT, ROOT))
        ts.set_pixels(teng.sim.particles.reshape(4, ROOT, ROOT))
    elif case == "geometry":
        js, ts = _make("GeometrySpawner", None, None, seed=3)
        js.shuffle()
        ts.triangles = torch.as_tensor(np.array(js.triangles))
    else:
        js, ts = _make("PixelSpawner", case, _image(), speed=0.3)
        js.spawn_matrix[0, 0] = ts.spawn_matrix[0, 0] = -1  # flip X
    before = {k: getattr(teng.sim, k).clone()
              for k in ("particles", "previous", "targets")}
    with jax.disable_jit():
        js.spawn(jeng, target=target)
    ts.spawn(teng, target=target)
    assert teng.timer.time == jeng.timer.time
    conf = tspawners._PIXEL_SHADERS[ts.shader]
    src = "previous" if target else "particles"
    data = ts.buffer
    mask = _hash_mask(conf, before[src].numpy(), teng._uv.T.numpy(),
                      np.float32(teng.timer.time), data.numpy())
    name = "targets" if target else "particles"
    _close_on(mask, getattr(teng.sim, name).numpy(),
              np.asarray(getattr(jeng.sim, name)))
    if target:
        assert teng._targets_live and jeng._targets_live
        for k in ("particles", "previous"):
            assert torch.equal(getattr(teng.sim, k), before[k])
    else:
        assert not teng._targets_live
        assert torch.equal(teng.sim.previous, before["particles"])
        assert torch.equal(teng.sim.targets, before["targets"])
        assert teng.sim.force is None


def test_set_pixels_keeps_its_own_copy():
    """A grid handed over by the sim is copied: writing into the sim's
    tensor afterwards changes nothing the spawner reads."""
    flow = torch.as_tensor(_flow_grid())
    sp = tspawners.PixelSpawner("flow-sample").set_pixels(flow)
    kept = sp.buffer.clone()
    flow.zero_()
    assert torch.equal(sp.buffer, kept)
    img = _image()
    sp = tspawners.PixelSpawner("direct", buffer=img)
    img[:] = 0.0
    assert sp.buffer.abs().sum() > 0
