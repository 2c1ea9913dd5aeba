"""The rest of tests/test_torch_app_corridors.py: the preset corridors of
its remaining presets and the post-stack corridor (`POST_BANDS`), held
the same way (see that file): inside every band the JAX demo's kernel
path keeps, and within the bands' own x0.75 to x1.25 of that path's
statistics everywhere.
"""

import numpy as np
import pytest

from tendrils_tpu.app.demo import TendrilsDemo as JDemo
from tendrils_tpu_torch.app.demo import TendrilsDemo as TDemo
from test_preset_corridors import BANDS, POST_BANDS
from test_torch_app_corridors import FIRST, SIZE, _hold, _run, check_preset

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)


def post_stats(demo):
    """tests/test_preset_corridors.py's masses of the screen."""
    screen = np.asarray(demo.screen)
    return {"rgb_mass": float(np.abs(screen[:3]).sum()),
            "alpha_mass": float(np.abs(screen[3]).sum())}


@pytest.mark.parametrize("preset", [k for k in BANDS if k not in FIRST])
def test_preset_corridor(preset):
    check_preset(preset)


def test_post_stack_corridor():
    """The blur and bokeh post stack through the demo's io frame:
    `Pissarides` (blur radius 12, limit 0.3) with the bokeh (3, 40)."""
    port = _run(TDemo({"quality": 0}, device="cpu", **SIZE), "Pissarides",
                set(POST_BANDS), post_stats, bokeh=True)
    ref = _run(JDemo({"quality": 0}, splat_backend="pallas",
                     gather_backend="pallas", **SIZE), "Pissarides",
               set(POST_BANDS), post_stats, bokeh=True)
    assert _hold(POST_BANDS, port, ref, "post") > 0
