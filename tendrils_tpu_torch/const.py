"""Shared constants (a copy of `tendrils_tpu/const.py`, which cannot be
imported without importing JAX).

The reference's constant GLSL modules:
  - inert sentinel: reference `src/const/inert.glsl:1` (`vec2(-1000000.0)`) and
    `src/const/inert.js`. The inert sentinel is load-bearing: dead particles
    park at this position and the logic step skips them
    (reference `src/logic.frag:55`).
  - tau / pi: reference `src/const/{tau,pi}.glsl`.
  - epsilon: reference `src/const/epsilon.glsl` (1e-9).
"""

import numpy as np

INERT = np.float32(-1.0e6)
PI = np.float32(3.14159265358979323846)
TAU = np.float32(6.28318530717958647692)
EPSILON = np.float32(1.0e-9)

# Reference fixed timestep: `src/index.js:67` (`step: 1000/60` — time in ms).
DEFAULT_STEP_MS = 1000.0 / 60.0
