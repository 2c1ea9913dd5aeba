"""Hash randoms — the `glsl-random` hash of the reference's spawn shaders
(`src/spawn/ball/index.frag:6-14`), as in `tendrils_tpu/ops/rand.py`:

    dt = dot(co, vec2(12.9898, 78.233));
    sn = mod(dt, 3.14);
    return fract(sin(sn) * 43758.5453);

The `* 43758.5453` amplifies one ulp of `sin` into ~3e-3 of the result, so
two libraries whose `sin` differ in the last bit give visibly different
hashes for those inputs (XLA's CPU `sin` and torch's differ on a few per
cent of arguments). The JAX module's threefry `uniform` has no counterpart:
the stochastic spawns (`spawn.ball_random`, `spawn.shuffle_triangles`) take
an explicit `torch.Generator`.
"""

import torch


def mod(x, y):
    """GLSL/`jnp.mod` float modulo: `fmod`, shifted into the divisor's sign
    (exact, unlike `x - y * floor(x / y)`)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def glsl_random(co):
    """`glsl-random` hash: `co: f32[..., 2] -> f32[...]` in [0, 1)."""
    d = co[..., 0] * 12.9898 + co[..., 1] * 78.233
    d = mod(d, 3.14)
    s = torch.sin(d) * 43758.5453
    return s - torch.floor(s)
