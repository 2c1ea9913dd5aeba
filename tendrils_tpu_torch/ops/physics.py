"""Integrators — ref `src/physics/{euler,verlet}/index.glsl` and their JS
twins (`index.js`, `vec2.js`), as `tendrils_tpu/ops/physics.py`.

The logic step uses its own inline Euler (`src/logic.frag:97`, kept in
`ops/logic.py`); these standalone forms exist for parity and for the audio
analysis, which differentiates with `eulerDyDt` (`src/analyse/index.js:18`).
Plain arithmetic: they work on numbers, numpy arrays and tensors of any
shape.
"""


def euler(vel, pos, dt):
    """Forward Euler — ref `physics/euler/index.glsl`."""
    return pos + vel * dt


def euler_dy_dt(pos0, pos1, dt):
    """Differentiation inverse — ref `physics/euler/index.js:17`."""
    return (pos1 - pos0) / dt


def verlet(acc, pos0, pos1, dt0, dt1=None):
    """Verlet integration — ref `physics/verlet/index.glsl` (time-corrected
    form; constant-step overloads pass dt0 == dt1)."""
    if dt1 is None:
        dt1 = dt0
    return (2.0 * pos1) - pos0 + acc * dt0 * dt1


def verlet_dy_dt(pos0, pos1, pos2, dt0, dt1=None):
    """Acceleration from positions — ref `physics/verlet/index.js:31-33`."""
    if dt1 is None:
        dt1 = dt0
    return (pos2 - (2.0 * pos1) + pos0) / dt0 / dt1
