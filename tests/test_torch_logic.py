"""The port's spawn and logic step against the JAX package's, on the same
seeded inputs; the step's dispatch to K13 (`ops/logic_cuda.py`) and its
plain version, and K13's C entry against its ctypes signature."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, state as jstate
from tendrils_tpu.ops import logic as jlogic, noise as jnoise, rand as jrand
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine, state as tstate
from tendrils_tpu_torch.ops import cuda_lib, gather_cuda, logic_cuda
from tendrils_tpu_torch.ops import logic as tlogic, noise as tnoise
from tendrils_tpu_torch.ops import rand as trand, spawn as tspawn

# Transcendentals (sin, cos, exp) differ in the last bit between XLA and
# torch; the noise itself is floor/abs/mul/add only.
RTOL, ATOL = 1e-5, 1e-6


def _frag_xy(root):
    uv = jstate.particle_coords_from_idx(jnp.arange(root * root), root)[0]
    return np.asarray(uv) * root


def test_noise_matches():
    rng = np.random.default_rng(0)
    v = rng.uniform(-50, 50, (3, 4096)).astype(np.float32)
    j = jnoise.snoise3_xyz(*v)
    t = tnoise.snoise3_xyz(*torch.as_tensor(v))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_ball_matches():
    """`spawn.ball` hashes with `fract(sin(.) * 43758.5453)`, which keeps
    8 bits: one ulp of sin or of its argument moves the hash by 1/256. So
    the JAX function runs op by op (jitted, XLA's CPU backend contracts
    multiply-adds into FMAs), and rows where XLA's and torch's sin differ
    in the last bit get a different (equally valid) draw. Every row whose
    four hashes agree bit for bit must match at RTOL/ATOL, and those must
    be nearly all rows; the rest stay within the disc."""
    root = 32
    fxy = _frag_xy(root)
    with jax.disable_jit():
        j = np.asarray(jspawn.ball(jnp.zeros((4, root * root)),
                                   jnp.asarray(fxy), 0.6, 0.01))
    t = tspawn.ball(None, torch.as_tensor(fxy), 0.6, 0.01).numpy()
    fx = fxy.T
    same = np.ones(root * root, bool)
    for a, b in ((1.7654, 2.3675), (1.23494, 0.36434),
                 (0.327789, 3.498787), (9.0374, 0.2773)):
        co = (fx * np.float32(a) + np.float32(b)).astype(np.float32)
        jh = np.asarray(jrand.glsl_random(jnp.asarray(co)))
        th = trand.glsl_random(torch.as_tensor(co)).numpy()
        assert np.abs(jh - th).max() <= 2 / 256  # an ulp, amplified
        same &= jh == th
    assert same.mean() > 0.8
    np.testing.assert_allclose(t[:, same], j[:, same], rtol=RTOL, atol=ATOL)
    assert (np.hypot(t[0], t[1]) <= 0.6 + 1e-6).all()
    assert (np.hypot(t[2], t[3]) <= 0.01 + 1e-8).all()


def test_step_particles_matches():
    """`logic.step_particles` with noise, parameter variance, target seek,
    the speed clamp and inert rows, the flow force supplied."""
    rng = np.random.default_rng(1)
    root = 32
    n = root * root
    particles = np.concatenate([
        rng.uniform(-1, 1, (2, n)), rng.uniform(-0.01, 0.01, (2, n))]
    ).astype(np.float32)
    particles[:2, rng.random(n) < 0.1] = -1e6
    targets = rng.uniform(-1, 1, (4, n)).astype(np.float32)
    force = rng.uniform(-0.02, 0.02, (2, n)).astype(np.float32)
    idx = rng.permutation(n).astype(np.int32)
    vs = np.asarray([1.5, 1.0], np.float32)
    jp = jengine.default_params()
    jp["target"] = jnp.float32(0.02)
    jp["noiseWeight"] = jnp.float32(0.05)  # make the noise term count
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    time, dt = np.float32(1234.5), np.float32(1000.0 / 60.0)

    uv, i01, _ = jstate.particle_coords_from_idx(jnp.asarray(idx), root)
    j = jlogic.step_particles(
        jnp.asarray(particles), None, jnp.asarray(targets), jp, uv, i01,
        jnp.asarray(vs), time, dt, flow_force_fn=lambda p: jnp.asarray(force))
    tuv, ti01, _ = tstate.particle_coords_from_idx(torch.as_tensor(idx),
                                                   root)
    tforce = torch.as_tensor(force)
    t = tlogic.step_particles(
        torch.as_tensor(particles), None, torch.as_tensor(targets), tp, tuv,
        ti01, torch.as_tensor(vs), torch.as_tensor(time),
        torch.as_tensor(dt), flow_force_fn=lambda p: tforce)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)
    # Inert rows are untouched.
    dead = particles[0] == -1e6
    np.testing.assert_array_equal(t.numpy()[:, dead], particles[:, dead])


def test_step_particles_flow_sampling_matches():
    """The flow-sampling path of the step (`flow.flow_at_screen_pos`
    through `sample.bilinear_sample`), noise off."""
    rng = np.random.default_rng(2)
    n, h, w = 2048, 24, 40
    particles = np.concatenate([
        rng.uniform(-1.1, 1.1, (2, n)), rng.uniform(-0.01, 0.01, (2, n))]
    ).astype(np.float32)
    flow = np.stack([rng.uniform(-0.01, 0.01, (h, w)),
                     rng.uniform(-0.01, 0.01, (h, w)),
                     rng.uniform(900, 1000, (h, w)),
                     rng.uniform(0, 1, (h, w))]).astype(np.float32)
    vs = np.asarray([40 / 24, 1.0], np.float32)
    jp = jengine.default_params()
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    uv = rng.uniform(0, 1, (2, n)).astype(np.float32)
    i01 = rng.uniform(0, 1, n).astype(np.float32)
    time, dt = np.float32(1000.0), np.float32(1000.0 / 60.0)
    j = jlogic.step_particles(
        jnp.asarray(particles), [jnp.asarray(flow)],
        jnp.zeros((4, n)), jp, jnp.asarray(uv), jnp.asarray(i01),
        jnp.asarray(vs), time, dt)
    t = tlogic.step_particles(
        torch.as_tensor(particles), [torch.as_tensor(flow)],
        torch.zeros((4, n)), tp, torch.as_tensor(uv), torch.as_tensor(i01),
        torch.as_tensor(vs), torch.as_tensor(time), torch.as_tensor(dt))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


# --- K13: the step's dispatch, its plain version, its C entry ----------------

LOGIC_CU = (pathlib.Path(tengine.__file__).parent / "csrc" / "logic.cu"
            ).read_text()


def _engine(**cfg_kw):
    """A CPU facade after a ball spawn and 2 frames (a carried force)."""
    cfg = tengine.EngineConfig(root_num=16, view_res=(32, 128),
                               flow_samples=2, flow_rows=1, view_samples=2,
                               **cfg_kw)
    eng = tengine.Tendrils(cfg, device="cpu").setup()
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.state["target"] = 0.01  # make the target term count
    eng.frame()
    eng.frame()
    return eng


def test_step_sim_counts_the_plain_version():
    """On CPU tensors every step runs K13's plain version once (a frame, a
    headless step) and launches nothing."""
    eng = _engine()
    cuda_lib.reset_counts()
    eng.frame()
    assert cuda_lib.plain_calls["logic_step"] == 1
    tengine.run_headless(eng.sim, eng.params(), eng.config, eng._view_size,
                         eng.timer.time, 1000.0 / 60.0, 3)
    assert cuda_lib.plain_calls["logic_step"] == 4
    assert not cuda_lib.launches


def _kernel_force(sim, params, time, view_size, cfg):
    """The in-step K5 gather as `step_particles`' `flow_force_fn` (one flow
    level): the decayed flow sampled at the screen positions."""
    eff = tengine._decayed(sim.flow, time, params)
    _, h, w = eff.shape

    def fn(pos_screen):
        u = pos_screen * 0.5 + 0.5
        force = 0.0 + gather_cuda.bilinear_gather(
            eff, u[:, 0] * w, u[:, 1] * h) * 1.0
        return force / (0.0 + 1.0)
    return fn


@pytest.mark.parametrize("source", ["carried", "kernel", "xla", "flow_off"])
def test_step_sim_force_sources_match_step_particles(source):
    """`step_sim` on each flow-force source (the carried force, the gather
    on the "kernel" and "xla" backends, none under `flow_off`) gives what
    `logic.step_particles` gives on the same inputs, bit for bit."""
    eng = _engine(gather_backend="xla" if source == "xla" else "kernel")
    sim, params, cfg = eng.sim, eng.params(), eng.config
    # The carried force needs the "kernel" gather (`carry_enabled`).
    assert (sim.force is not None) == (source != "xla")
    if source == "kernel":
        sim = dataclasses.replace(sim, force=None)
    time = torch.tensor(eng.timer.time + 1000.0 / 60.0, dtype=torch.float32)
    dt = torch.tensor(1000.0 / 60.0, dtype=torch.float32)
    flows, fn = None, None
    if source == "carried":
        fn = lambda pos_screen: sim.force  # noqa: E731
    elif source == "kernel":
        fn = _kernel_force(sim, params, time, eng._view_size, cfg)
    elif source == "xla":
        flows = [sim.flow]
    else:
        fn = lambda pos_screen: 0.0  # noqa: E731
    uv, i01, _ = tstate.particle_coords_from_idx(sim.idx, cfg.root_num)
    want = tlogic.step_particles(sim.particles, flows, sim.targets, params,
                                 uv, i01, eng._view_size, time, dt,
                                 flow_force_fn=fn)
    cuda_lib.reset_counts()
    got = tengine.step_sim(sim, params, time, dt, cfg, eng._view_size,
                           flow_off=source == "flow_off")
    assert dict(cuda_lib.plain_calls) == {
        "logic_step": 1, **({"bilinear_gather": 1} if source == "kernel"
                            else {})}
    assert torch.equal(got.particles, want)
    assert got.previous is sim.particles and got.force is None


def _c_params(entry):
    """The parameter list of C entry `entry` in csrc/logic.cu."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", LOGIC_CU)
    assert m, entry
    return [p.strip() for p in m.group(1).split(",")]


def test_signature_matches_the_c_entry():
    """`_SIGNATURES["tt_logic_step"]` has an argument for each parameter of
    the C entry, pointers where it takes pointers, ints where ints."""
    params = _c_params("tt_logic_step")
    sig = cuda_lib._SIGNATURES["tt_logic_step"]
    assert len(sig) == len(params) == 24
    for arg, decl in zip(sig, params):
        assert (arg is cuda_lib._P) == ("*" in decl), decl
        assert (arg is cuda_lib._I) == decl.startswith("int "), decl


def test_param_order_matches_the_kernel():
    """`logic_cuda.PARAM_KEYS`, then time and dt, are the order of the
    kernel's `Param` enum and of the C entry's parameter pointers."""
    enum = re.search(r"enum Param \{([^}]*)\}", LOGIC_CU).group(1)
    names = [n.strip() for n in enum.split(",")][:-1]  # N_PARAMS last
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", k).upper()
             for k in logic_cuda.PARAM_KEYS] + ["TIME", "DT"]
    assert names == snake
    pointers = [p.split("*")[-1].strip() for p in _c_params("tt_logic_step")]
    assert pointers[6:22] == [n.lower() for n in snake]


def test_logic_step_plain_without_force_adds_zero():
    """K13's plain version with no force is the step whose flow term is the
    number 0.0 (the `flow_off` step), and each row is the same function of
    its own index whatever the row order."""
    rng = np.random.default_rng(3)
    root = 16
    n = root * root
    particles = torch.as_tensor(np.concatenate([
        rng.uniform(-1, 1, (2, n)), rng.uniform(-0.01, 0.01, (2, n))]
    ).astype(np.float32))
    targets = torch.as_tensor(rng.uniform(-1, 1, (4, n)).astype(np.float32))
    idx = torch.as_tensor(rng.permutation(n).astype(np.int32))
    params = tstate.params_from_state(tstate.default_state(), device="cpu")
    time, dt = torch.tensor(500.0), torch.tensor(1000.0 / 60.0)
    got = logic_cuda.logic_step(particles, targets, idx, None, params, time,
                                dt, root)
    uv, i01, _ = tstate.particle_coords_from_idx(idx, root)
    want = tlogic.step_with_force(particles, targets, params, uv, i01, time,
                                  dt, 0.0)
    assert torch.equal(got, want)
    perm = torch.as_tensor(rng.permutation(n))
    again = logic_cuda.logic_step(particles[:, perm], targets[:, perm],
                                  idx[perm], None, params, time, dt, root)
    assert torch.equal(again, got[:, perm])
