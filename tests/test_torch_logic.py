"""The port's spawn and logic step against the JAX package's, on the same
seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tendrils_tpu import engine as jengine, state as jstate
from tendrils_tpu.ops import logic as jlogic, noise as jnoise, rand as jrand
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, state as tstate
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
