"""`flow_off` (`flowWeight == 0`, BASELINE config 1): the port against the
JAX package (its Pallas kernels in interpret mode) and against its own
ungated frame.

With `flowWeight == 0` the step's flow term is exactly zero, so the JAX
engine gathers no force and its kernel draw prunes the five flow channels:
K2 splats the view's six and K3 resolves the view alone, the flow grid
passing through untouched (`draw_pallas.py:1610-1640`). The port does the
same on its view-only K2 and K3 (plain versions on the CPU). The JAX
engine prunes only on its "pallas" backends, so the JAX side runs them.

Tolerances: K2's view-only accumulator as tests/test_torch_draw.py holds
the 11-channel one (the TPU kernel rounds its matmul operands to bf16:
1e-2 of each channel's max, totals within 5e-3 of its mass); K3 rtol 1e-5
/ atol 1e-6; frames by identity with `torch_parity.compare`. The port's
own contract is exact: the view-only planes are the 11-channel call's
planes 5-10 bit for bit, and 4 frames with and without the gate give the
same particles and view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine
from tendrils_tpu.ops import draw_pallas as jdraw, spawn as jspawn
from tendrils_tpu_torch import engine as tengine, flow_line
from tendrils_tpu_torch.ops import coords, cuda_lib, draw_cuda as tdraw
from test_torch_draw import (FLOW_DECAY, GRIDS, SPEED_LIMIT, TIME, _case,
                             _draw_kw)
from torch_parity import compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2, splat_backend="pallas", gather_backend="pallas")
FRAMES = 4
DT = 1000.0 / 60.0
VARIANTS = ["resident", "classic"]


# --- K2 and K3 view-only -----------------------------------------------------


def _classic_inputs(c, seed=5):
    """A classic draw's extra inputs: a textured colour map's per-particle
    values (`f32[4, N]`) for K1's rgba8 word."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (4, c["idx"].size)).astype(np.float32)


def _accumulate(side, grid_hw, c, variant, flow_off):
    """`fused_draw_accumulate(raw_accum=True)` on `side` ("jax" or
    "torch"): the resident variant (derive_p0, a 1x1 map's scalar colour,
    the riding positions and ids) or the classic one (the exact p0 and
    rgba8 words, no ids). Returns `(accum, sorted ids or None)` as numpy."""
    arr = jnp.asarray if side == "jax" else torch.as_tensor
    kw = dict(_draw_kw(c), flow_off=flow_off)
    common = dict(base_color=arr(c["base"]), flow_color=arr(c["flow_color"]))
    if side == "jax":
        common["interpret"] = True
    if variant == "resident":
        args = (None if side == "torch" else arr(c["p0"]), arr(c["p1"]),
                arr(c["vel"]), None if side == "torch" else arr(c["pos"]),
                None)
        extra = dict(idx=arr(c["idx"]), ride=[arr(c["pos"][0]),
                                              arr(c["pos"][1])],
                     idx_bound=c["idx"].size, view_size=arr(c["vs"]),
                     mapped_scalar=arr(c["mapped"]))
    else:
        kw["derive_p0"] = False
        args = (arr(c["p0"]), arr(c["p1"]), arr(c["vel"]), arr(c["pos"]),
                arr(_classic_inputs(c)))
        extra = {}
    sl = jnp.float32(SPEED_LIMIT) if side == "jax" else SPEED_LIMIT
    tm = jnp.float32(TIME) if side == "jax" else TIME
    out = (jdraw if side == "jax" else tdraw).fused_draw_accumulate(
        grid_hw, *args, arr(c["live"]), sl, tm, **common, **extra, **kw)
    n = c["idx"].size
    ids = None if variant == "classic" else np.asarray(out[2][0])[:n]
    return np.asarray(out[0]), ids


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("grid_hw,root", GRIDS)
def test_view_only_splat_matches_jax(grid_hw, root, variant):
    """K2 view-only (plain on the CPU) against the JAX draw's pruned
    accumulator, with test_torch_draw.py's tolerance; the integer streams
    (the sorted ids) bit-exact."""
    c = _case(grid_hw, root)
    cuda_lib.reset_counts()
    ta, tids = _accumulate("torch", grid_hw, c, variant, True)
    ja, jids = _accumulate("jax", grid_hw, c, variant, True)
    name = "splat_view" if variant == "resident" else "splat_p0_rgba_view"
    assert cuda_lib.plain_calls[name] == 1
    assert ta.shape == ja.shape == (tdraw.N_VIEW, *ja.shape[1:])
    if tids is not None:
        np.testing.assert_array_equal(tids, jids)
    scale = np.abs(ja).reshape(ja.shape[0], -1).max(axis=1)
    assert (scale > 0).all()
    assert (np.abs(ta - ja) <= 1e-2 * scale[:, None, None]).all()
    mass = np.abs(ja).sum(axis=(1, 2))
    assert (np.abs(ta.sum(axis=(1, 2)) - ja.sum(axis=(1, 2)))
            <= 5e-3 * mass).all()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("grid_hw,root", GRIDS)
def test_view_only_planes_are_the_full_calls(grid_hw, root, variant):
    """The port's own contract: the view-only accumulator is planes 5-10
    of the 11-channel one bit for bit, and K3 view-only gives the view K3
    gives from the 11 channels."""
    c = _case(grid_hw, root)
    full = _accumulate("torch", grid_hw, c, variant, False)[0]
    view_only = _accumulate("torch", grid_hw, c, variant, True)[0]
    np.testing.assert_array_equal(view_only, full[tdraw.N_FLOW:])
    h, w = grid_hw
    rng = np.random.default_rng(2)
    flow = torch.as_tensor(rng.uniform(0, 1, (4, h, w)).astype(np.float32))
    view = torch.as_tensor(rng.uniform(0, 1, (4, h, w)).astype(np.float32))
    args = ([0.1333, 0.1333, 0.1333, 0.05], 1.0, TIME, TIME + DT,
            FLOW_DECAY, 5.0, 1.0)
    nv = tdraw.resolve_fused(torch.as_tensor(view_only), None, view, *args,
                             flow_off=True)
    assert len(nv) == 1
    want = tdraw.resolve_fused(torch.as_tensor(full), flow, view, *args)[1]
    assert torch.equal(nv[0], want)


@pytest.mark.parametrize("grid_hw,root", GRIDS)
def test_view_only_resolve_matches_jax(grid_hw, root):
    """K3 view-only (plain) against the JAX `resolve_fused(flow_off=True)`
    on the same view-only accumulator: rtol 1e-5, atol 1e-6 (the same f32
    formula; exp differs by an ulp between XLA and torch)."""
    rng = np.random.default_rng(1)
    h, w = grid_hw
    accum = _accumulate("torch", grid_hw, _case(grid_hw, root), "resident",
                        True)[0]
    view = rng.uniform(0.0, 1.0, (4, h, w)).astype(np.float32)
    fade = np.asarray([0.1333, 0.1333, 0.1333, 0.05], np.float32)
    args = (fade, 0.0, TIME, TIME + DT, FLOW_DECAY, 5.0, 1.0)
    jout = jdraw.resolve_fused(
        jnp.asarray(accum), None, jnp.asarray(view),
        *(jnp.asarray(a, jnp.float32) for a in args), interpret=True,
        flow_off=True)
    cuda_lib.reset_counts()
    tout = tdraw.resolve_fused(torch.as_tensor(accum), None,
                               torch.as_tensor(view), *args, flow_off=True)
    assert cuda_lib.plain_calls["resolve_view"] == 1
    assert len(tout) == len(jout) == 1
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-6)


def test_view_only_refuses_eff_and_the_xla_tail():
    """The gate: no view-only resolve with `want_eff`, no pruned
    accumulator for the XLA tail (`raw_accum=False`), as the JAX asserts."""
    hp, wp = (48, 640)
    with pytest.raises(ValueError, match="eff"):
        tdraw.resolve_fused(torch.zeros(tdraw.N_VIEW, hp, wp), None,
                            torch.zeros(4, 32, 128), [0, 0, 0, 0], 0.0,
                            1.0, 1.0, 0.0, 1.0, 1.0, want_eff=True,
                            flow_off=True)
    c = _case((32, 128), 4)
    t = torch.as_tensor
    with pytest.raises(ValueError, match="raw_accum"):
        tdraw.fused_draw_accumulate(
            (32, 128), t(c["p0"]), t(c["p1"]), t(c["vel"]), t(c["pos"]),
            t(_classic_inputs(c)), t(c["live"]), SPEED_LIMIT, TIME,
            flow_off=True)


# --- frames at flowWeight == 0 -----------------------------------------------


@pytest.fixture(scope="module", params=VARIANTS)
def start(request):
    """The JAX engine spawned and run 2 frames with the flow on (a live
    flow grid and, resident, a carried force), then `flowWeight = 0`: its
    config, state and timer."""
    eng = jengine.Tendrils(jengine.EngineConfig(
        **CFG, resident_stream=request.param == "resident"))
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.frame()
    eng.frame()
    return eng.config, jax.tree_util.tree_map(jnp.array, eng.sim), \
        eng.timer.time


def _engines(start, flow_weight=0.0):
    cfg, sim0, t0 = start
    jeng = jengine.Tendrils(cfg)
    jeng.setup()
    jeng.sim = jax.tree_util.tree_map(jnp.array, sim0)
    jeng.timer.time = t0
    teng = port_engine(cfg, sim_arrays(sim0), t0)
    for eng in (jeng, teng):
        eng.state["flowWeight"] = flow_weight
    return jeng, teng


def _view_only_calls(cfg):
    """The port's plain calls of a pruned frame's K2, by residency."""
    return "splat_view" if cfg.resident_stream else "splat_p0_rgba_view"


def test_facade_frames_match_jax(start):
    """FRAMES facade frames at flowWeight 0 on each side: the same state
    (`compare`), no force, the flow grid frozen bit for bit on both sides;
    the port ran K2 and K3 view-only, K6 on the resident stream, and no
    gather (K4, K5, K7)."""
    jeng, teng = _engines(start)
    flow0 = teng.sim.flow.clone()
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        jeng.frame()
        teng.frame()
    calls = cuda_lib.plain_calls
    assert calls[_view_only_calls(teng.config)] == FRAMES
    assert calls["resolve_view"] == FRAMES and calls["resolve"] == 0
    assert calls["reconstruct_resident"] == (
        FRAMES if teng.config.resident_stream else 0)
    for k in ("gather_reconstruct", "bilinear_gather", "gather_keyed_q15",
              "gather_keyed_p1", "splat", "splat_p0_rgba"):
        assert calls[k] == 0, k
    assert teng.sim.force is None and jeng.sim.force is None
    assert torch.equal(teng.sim.flow, flow0)
    np.testing.assert_array_equal(np.asarray(jeng.sim.flow), flow0.numpy())
    compare(teng.sim, sim_arrays(jeng.sim))


def test_run_headless_matches_jax(start):
    """`run_headless(flow_off=True)` for FRAMES steps on each side."""
    cfg, sim0, t0 = start
    jeng, teng = _engines(start)
    jsim = jengine.run_headless(sim0, jeng.params(), cfg, jeng._view_size,
                                jnp.float32(t0), DT, FRAMES,
                                targets_live=False, fast_resolve=True,
                                flow_off=True)
    cuda_lib.reset_counts()
    tsim = tengine.run_headless(teng.sim, teng.params(), teng.config,
                                teng._view_size, t0, DT, FRAMES,
                                targets_live=False, flow_off=True)
    assert cuda_lib.plain_calls["bilinear_gather"] == 0
    assert cuda_lib.plain_calls[_view_only_calls(teng.config)] == FRAMES
    assert tsim.force is None and jsim.force is None
    assert torch.equal(tsim.flow, teng.sim.flow)
    compare(tsim, sim_arrays(jsim))


def _segments(i):
    """Two pointers' flow-line segments at frame i (5 crest rows each)."""
    h, w = CFG["view_res"]
    lines = flow_line.FlowLines()
    for j in range(i + 2):
        for p in range(2):
            a = 0.35 * j + np.pi * p
            lines.get(p).add(16.0 * j, (0.5 * np.cos(a), 0.45 * np.sin(a)))
    return lines.segments(0.0, coords.cover_aspect((w, h)), (h, w))


@pytest.mark.parametrize("seg_on", [False, True], ids=["plain", "segments"])
def test_io_frames_match_jax(start, seg_on):
    """2 io frames at flowWeight 0, with and without pointer segments:
    without, the draw prunes (flow frozen); with, it keeps all 11 channels
    and the segments edit the flow; no force either way."""
    jeng, teng = _engines(start)
    flow0 = teng.sim.flow.clone()
    cuda_lib.reset_counts()
    for i in range(2):
        kw = dict(segments=_segments(i)) if seg_on else {}
        assert jeng.step_draw_io(**kw) is None
        assert teng.step_draw_io(**kw) is None
    calls = cuda_lib.plain_calls
    pruned = calls[_view_only_calls(teng.config)]
    assert pruned == (0 if seg_on else 2)
    assert calls["splat_points"] == (2 if seg_on else 0)
    assert teng.sim.force is None and jeng.sim.force is None
    assert torch.equal(teng.sim.flow, flow0) != seg_on
    compare(teng.sim, sim_arrays(jeng.sim))


def test_flow_off_keeps_the_ungated_frame(start):
    """JAX's contract (tests/test_carry_force.py), on the port: from one
    converted state at flowWeight 0, FRAMES frames with the gate and
    FRAMES with it forced off give the same particles by identity and the
    same view bit for bit; gated, the flow grid is frozen and no force is
    carried."""
    runs = []
    for flow_off in (True, False):
        teng = _engines(start)[1]
        flow0 = teng.sim.flow.clone()
        for _ in range(FRAMES):
            teng.timer.tick()
            teng._check_force_params()
            x = teng._frame_inputs()
            teng.sim = tengine._frame(
                teng.sim, x.params, x.time, x.dt, teng.config,
                teng._view_size, targets_live=False,
                fast_resolve=x.fast_resolve, flow_off=flow_off,
                host_widths=x.host_widths)
        runs.append(teng.sim)
    a, b = runs
    pa = a.particles[:, torch.argsort(a.idx)]
    pb = b.particles[:, torch.argsort(b.idx)]
    assert torch.equal(pa, pb)
    # The classic ungated frame sorts by `tile << 20 | id` for its force
    # gather, the gated one by the tile alone; the plain splat's int64 sums,
    # like the card's, do not depend on the order of the adds.
    assert torch.equal(a.view, b.view)
    assert torch.equal(a.flow, flow0) and not torch.equal(b.flow, flow0)
    assert a.force is None


def test_toggle_matches_jax(start):
    """flowWeight 0 -> 1 -> 0, 2 frames each, on each side: the first frame
    at 1 finds no force and gathers it in the step (K5), as the JAX step
    does; the states agree after each stretch."""
    jeng, teng = _engines(start)
    for weight in (0.0, 1.0, 0.0):
        for eng in (jeng, teng):
            eng.state["flowWeight"] = weight
        cuda_lib.reset_counts()
        for _ in range(2):
            jeng.frame()
            teng.frame()
        assert cuda_lib.plain_calls["bilinear_gather"] == (1 if weight
                                                            else 0)
        assert (teng.sim.force is None) == (weight == 0.0)
        assert (jeng.sim.force is None) == (weight == 0.0)
        compare(teng.sim, sim_arrays(jeng.sim))


def test_flow_off_gate_is_the_jax_facades():
    """`flow_force_unused` reads the host state as the JAX function does."""
    for src in ({"flowWeight": 1.0}, {"flowWeight": 0.0}, {}, None):
        assert tengine.flow_force_unused(src) \
            == jengine.flow_force_unused(src)
