"""Spawner objects — the reference's spawner API surface for the slice
(`spawn_init`, `spawn_ball`; `tendrils_tpu/spawners.py`). Each object's
`spawn(tendrils, target=None)` routes through `Tendrils.spawn_shader`. The
pixel and geometry spawners are still to be ported (ROADMAP queue 1,
item 8).
"""

from .ops import spawn as ops


def spawner(op_factory, uniforms=None):
    """Generic wrapper — ref `src/spawn/init/index.js:10-27`.

    `op_factory(uniforms) -> op(prev_particles, engine) -> f32[4, N]`."""

    class _Spawner:
        def __init__(self):
            self.uniforms = dict(uniforms or {})

        def spawn(self, tendrils, target=None):
            tendrils.spawn_shader(op_factory(self.uniforms), target)
            return tendrils

    return _Spawner()


def spawn_init():
    """All-inert init spawner — ref `src/spawn/init/index.frag`."""
    return spawner(lambda u: lambda prev, eng: ops.init(prev))


def spawn_ball(radius=1.0, speed=0.0):
    """Uniform random disc spawner — ref `src/spawn/ball/index.js:7-15`
    (defaults radius 1, speed 0)."""
    return spawner(
        lambda u: lambda prev, eng: ops.ball(prev, eng._frag_xy,
                                             float(u["radius"]),
                                             float(u["speed"])),
        {"radius": radius, "speed": speed})
