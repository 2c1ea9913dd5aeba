"""Spawner objects — the reference's spawner API surface.

The port of `tendrils_tpu/spawners.py`: the `spawner()` bundles
(`src/spawn/init/index.js:10-27`), `PixelSpawner`
(`src/spawn/pixels/index.js:25-67`) and `GeometrySpawner`
(`src/spawn/geometry/index.js:35-111`). Each object's `spawn(tendrils,
target=None)` routes through `Tendrils.spawn_shader`, into the particle
ping-pong or, with `target="targets"`, the targets buffer.
"""

import numpy as np
import torch

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


# Named frag-shader configurations — ref `src/spawn/pixels/*.frag`.
_PIXEL_SHADERS = {
    # direct per-texel, colour apply + vignette (index.frag)
    "direct": dict(mode="direct", apply="color", vignette=True),
    # best-of-N samplers
    "best-sample": dict(mode="best", apply="color", vignette=True, samples=6,
                        test="particles"),
    "bright-sample": dict(mode="best", apply="brightest", vignette=False,
                          samples=6, test="particles"),
    "color-sample": dict(mode="best", apply="color", vignette=False,
                         samples=3, test="particles"),
    "data-sample": dict(mode="best", apply="identity", vignette=True,
                        samples=2, test="particles"),
    "flow-sample": dict(mode="best", apply="flow", vignette=False, samples=5,
                        test="particles"),
}

_APPLIES = {
    "color": ops.apply_color,
    "brightest": ops.apply_brightest,
    "flow": ops.apply_flow,
    "particles": ops.apply_particles,
    "simple": ops.apply_simple,
    "identity": ops.apply_identity,
}

_TESTS = {
    "particles": ops.test_particles,
    "brightest": ops.test_brightest,
}


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


class PixelSpawner:
    """Spawn particle state from an arbitrary texture — ref
    `src/spawn/pixels/index.js:25-67`.

    `buffer` holds the spawn-data grid (`f32[4, H, W]`): an image, a video
    frame, the engine's flow grid or a particle buffer. `shader` picks one
    of the reference frag configurations (see `_PIXEL_SHADERS`).

    `set_pixels` keeps a copy: a grid handed over by a frame (the flow,
    the particles) is a tensor the caller may go on using, and a spawn
    must read it as it was when it was set. The copy moves to the
    engine's device at the first spawn."""

    def __init__(self, shader="direct", buffer=None, spawn_size=(1.0, 1.0),
                 jitter_rad=2.0, speed=1.0, bias=1.0):
        self.shader = shader
        self.buffer = torch.zeros((4, 1, 1), dtype=torch.float32)
        if buffer is not None:
            self.set_pixels(buffer)
        self.speed = speed
        self.bias = bias
        self.jitter_rad = jitter_rad
        self.spawn_size = list(spawn_size)
        self.spawn_matrix = np.eye(3, dtype=np.float32)

    def set_pixels(self, grid):
        self.buffer = torch.as_tensor(grid, dtype=torch.float32).clone()
        return self

    def _op(self, flow_decay, device):
        conf = _PIXEL_SHADERS[self.shader]
        apply_fn = _APPLIES[conf["apply"]]
        if conf.get("vignette"):
            apply_fn = ops.with_vignette(apply_fn)
        self.buffer = self.buffer.to(device)
        spawn_data = self.buffer
        speed = float(np.float32(self.speed))
        bias = float(np.float32(self.bias))
        matrix = _f32(self.spawn_matrix, device)
        size = _f32(self.spawn_size, device)
        jit_rad = self.jitter_rad

        def op(prev, eng):
            h, w = eng.config.view_res
            # aspect(jitter, viewRes, jitterRad) — ref pixels/index.js:56.
            jitter = _f32([jit_rad / w, jit_rad / h], device)
            data_uv = eng._uv.T  # [N, 2]
            time = _f32(eng.timer.time, device)
            kw = dict(apply_fn=apply_fn, speed=speed, spawn_matrix=matrix,
                      spawn_size=size, jitter=jitter, time=time)
            if conf["apply"] == "flow":
                kw["decay"] = flow_decay
            if conf["mode"] == "direct":
                return ops.pixels_direct(prev, spawn_data, data_uv, **kw)
            return ops.pixels_best_sample(
                prev, spawn_data, data_uv, test_fn=_TESTS[conf["test"]],
                samples=conf["samples"], bias=bias, **kw)

        return op

    def spawn(self, tendrils, update=None, target=None):
        flow_decay = _f32(tendrils.state.get("flowDecay", 0.0),
                          tendrils.device)
        tendrils.spawn_shader(self._op(flow_decay, tendrils.device), target)
        return tendrils


class GeometrySpawner(PixelSpawner):
    """Random "platonic" triangle fans rasterised then bright-sampled — ref
    `src/spawn/geometry/index.js:35-111`. The fans are drawn from the
    spawner's own `torch.Generator` (on the CPU), seeded with `seed`."""

    def __init__(self, speed=0.005, bias=100 / 5e-3, shuffles=None,
                 color=(1.0, 1.0, 1.0, 1.0), seed=0, **kw):
        super().__init__(shader="bright-sample", speed=speed, bias=bias,
                         **kw)
        base = dict(size=2, count=3, radii=(0.25, 1.3), arcs=(1e-2, 3e-2),
                    obtuse={"rate": 0.5, "pad": 0.25})
        base.update(shuffles or {})
        self.shuffles = base
        self.color = color
        self.generator = torch.Generator().manual_seed(seed)
        self.triangles = None

    def shuffle(self):
        """Regenerate the triangle fan — ref `geometry/index.js:54-91`."""
        s = self.shuffles
        self.triangles = ops.shuffle_triangles(
            self.generator, count=s["count"], radii=s["radii"],
            arcs=s["arcs"], obtuse_rate=s["obtuse"]["rate"],
            obtuse_pad=s["obtuse"]["pad"])
        return self

    def spawn(self, tendrils, update=None, target=None):
        if self.triangles is None:
            self.shuffle()
        # Rasterise at 0.2x view res — ref `geometry/index.js:94`.
        h, w = tendrils.config.view_res
        small = (max(8, int(h * 0.2)), max(8, int(w * 0.2)))
        self.buffer = ops.rasterize_triangles(
            self.triangles, small, tendrils._view_size, self.color)
        return super().spawn(tendrils, update, target)
